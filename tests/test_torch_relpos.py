"""BEiT relative-position bias in the port vs the JAX package on the CPU,
float32, tiny widths: the index functions, the table resample, the whole
encoder with per-layer, shared and both kinds of tables (with and
without windows, on a divisible and a padded grid, and at a grid other
than the trained one: taps and every gradient, the tables' included);
plus the config, parameter and inference-cast plumbing of
``configs/train_1024_window_relpos.json``."""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu_torch.config import load_run_config
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models import weights_io

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "train_1024_window_relpos.json"
VIT = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128)
TABLE_TOL = 1e-6
TAP_TOL = 1e-4
GRAD_RTOL = 1e-3  # relative Frobenius, per leaf
TABLES = {
    "layer": dict(use_relative_position_bias=True, use_absolute_position_embeddings=False),
    "shared": dict(use_shared_relative_position_bias=True),  # beside absolute embeddings
    "both": dict(use_relative_position_bias=True, use_shared_relative_position_bias=True,
                 use_absolute_position_embeddings=False),
}


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("grid", [4, 5, 14])
def test_relative_position_indices_match_jax(grid):
    np.testing.assert_array_equal(port_vit.relative_position_index(grid),
                                  jax_vit.relative_position_index(grid))
    for ws in sorted({1, 2, 3, grid // 2, grid}):
        np.testing.assert_array_equal(port_vit.window_relative_position_index(ws, grid),
                                      jax_vit.window_relative_position_index(ws, grid))
    with pytest.raises(ValueError, match="larger than grid"):
        port_vit.window_relative_position_index(grid + 1, grid)
    # built once per grid on its device, as the index type torch gathers with
    idx = port_vit._rel_index(torch.device("cpu"), grid, 0)
    assert idx is port_vit._rel_index(torch.device("cpu"), grid, 0)
    assert idx.dtype == torch.int64
    # the gathered bias is the flash kernels' contiguous fp32 [H, N, N]
    table = torch.randn((2 * grid - 1) ** 2 + 3, 3)
    bias = port_vit._gather_rel_bias(table, grid, 0)
    assert bias.shape == (3, grid * grid + 1, grid * grid + 1) and bias.is_contiguous()
    want = jax_vit._gather_rel_bias(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(bias.numpy(), np.asarray(want)[0])


@pytest.mark.parametrize("grid,ws", [(4, 0), (5, 0), (7, 0), (5, 1), (5, 2), (7, 3), (6, 6)])
def test_rel_table_gradient_is_the_scatter_of_the_gather(rng, grid, ws):
    """The gather's backward (sums over diagonal bands) against autograd's
    backward of plain advanced indexing (a scatter-add by index), and the
    same bits on a second run."""
    entries, h = (2 * grid - 1) ** 2 + 3, 3
    table = torch.from_numpy(rng.standard_normal((entries, h)).astype(np.float32))
    table.requires_grad_(True)
    bias = port_vit._gather_rel_bias(table, grid, ws)
    plain = table.t()[:, port_vit._rel_index(torch.device("cpu"), grid, ws)]
    torch.testing.assert_close(bias, plain, rtol=0, atol=0)
    dbias = torch.from_numpy(rng.standard_normal(tuple(bias.shape)).astype(np.float32))
    (got,) = torch.autograd.grad(bias, table, dbias, retain_graph=True)
    (want,) = torch.autograd.grad(plain, table, dbias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, torch.autograd.grad(bias, table, dbias)[0])
    if ws:  # entries no window offset reaches get nothing
        assert not got[-3:].any() and (got != 0).sum() == (2 * ws - 1) ** 2 * h


@pytest.mark.parametrize("g0,g", [(4, 6), (6, 4), (5, 5)])
def test_rel_table_for_grid_matches_jax(rng, g0, g):
    table = rng.standard_normal(((2 * g0 - 1) ** 2 + 3, 3)).astype(np.float32)
    want = np.asarray(jax_vit._rel_table_for_grid(jnp.asarray(table), g0, g))
    got = port_vit._rel_table_for_grid(torch.from_numpy(table), g0, g)
    assert got.shape == ((2 * g - 1) ** 2 + 3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TABLE_TOL, rtol=TABLE_TOL)
    np.testing.assert_array_equal(got.numpy()[-3:], table[-3:])  # the CLS entries pass through


def _jax_params(cfg, rng):
    """JAX's init with every zero-initialised embedding and table drawn
    at random, so a wrong index or a dropped bias would show."""
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_vit.init_vit_params(jax.random.PRNGKey(0), cfg))
    draw = lambda a, s: (s * rng.standard_normal(a.shape)).astype(np.float32)  # noqa: E731
    params["cls_token"] = draw(params["cls_token"], 0.02)
    for name, s in (("pos_embed", 0.02), ("shared_rel_pos_table", 0.5)):
        if name in params:
            params[name] = draw(params[name], s)
    for layer in params["layers"]:
        if "rel_pos_table" in layer:
            layer["rel_pos_table"] = draw(layer["rel_pos_table"], 0.5)
    return params


@pytest.mark.parametrize("tables", sorted(TABLES))
@pytest.mark.parametrize("size,ws,image", [
    (64, 0, 64),  # no windows
    (64, 2, 64),  # 2 x 2 windows on the 4 x 4 grid; layer 3 windowed
    (80, 3, 80),  # 3 x 3 windows on the 5 x 5 grid, padded
    (64, 0, 96),  # tables trained at grid 4, run at grid 6 (resampled)
])
def test_vit_forward_with_rel_pos_matches_jax(rng, tables, size, ws, image):
    kw = dict(VIT, image_size=size, window_size=ws, **TABLES[tables])
    jcfg, pcfg = jax_vit.ViTConfig(**kw), port_vit.ViTConfig(**kw)
    jparams = _jax_params(jcfg, rng)
    x = rng.uniform(-1, 1, (2, 3, image, image)).astype(np.float32)
    taps = (1, 2, 3, 4)
    g = image // 16
    cots = [rng.standard_normal((2, 1 + g * g, 64)).astype(np.float32) for _ in taps]

    def total(p):
        outs = jax_vit.vit_forward(p, jnp.asarray(x), jcfg, taps=taps)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, want), jgrads = jax.value_and_grad(total, has_aux=True)(jparams)

    params = weights_io.vit_params_from_jax(jparams)
    assert ("pos_embed" in params) == pcfg.use_absolute_position_embeddings
    leaves = weights_io.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    got = port_vit.vit_forward(params, torch.from_numpy(x), pcfg, taps=taps)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), atol=TAP_TOL, rtol=TAP_TOL)
    sum((t * torch.from_numpy(c)).sum() for t, c in zip(got, cots)).backward()
    grads = weights_io.vit_params_to_jax(weights_io.tree_map(lambda t: t.grad, params))
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jgrads))[0]
    flat_p = jax.tree_util.tree_leaves(grads)
    assert len(flat_j) == len(flat_p)
    n_tables = 0
    for (path, w), gp in zip(flat_j, flat_p):
        name = jax.tree_util.keystr(path)
        assert gp.shape == w.shape, name
        assert _rel_frob(gp, w) <= GRAD_RTOL, (name, _rel_frob(gp, w))
        n_tables += "rel_pos_table" in name
    assert n_tables == 4 * pcfg.use_relative_position_bias + pcfg.use_shared_relative_position_bias


def test_rel_pos_needs_a_square_grid():
    cfg = port_vit.ViTConfig(**VIT, image_size=64, **TABLES["layer"])
    params = port_vit.init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="square patch grid"):
        port_vit.vit_forward(params, torch.zeros(1, 3, 64, 80), cfg)


# ------------------------------------------------- config, weights, casts


def test_load_run_config_train_1024_window_relpos():
    from layoutdit_tpu.config.constructs import LayoutDitConfig
    from layoutdit_tpu.models.detection.detector import DetectorConfig as JaxDetectorConfig
    from layoutdit_tpu_torch.models.detection.detector import DetectorConfig

    rc = load_run_config(str(CONFIG))
    with open(CONFIG) as f:
        jm = LayoutDitConfig(**json.load(f)).detection_model_config
    assert rc.run_name == "train-1024-window-relpos"
    assert (rc.model.image_size, rc.data.batch_size, rc.model.window_size) == (1024, 4, 16)
    vit = DetectorConfig.from_model_config(rc.model, rc.compute_dtype).backbone.vit
    jvit = JaxDetectorConfig.from_model_config(jm).backbone.vit
    for name in ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
                 "patch_size", "image_size", "layer_scale_init_value", "window_size",
                 "use_absolute_position_embeddings", "use_relative_position_bias",
                 "use_shared_relative_position_bias"):
        assert getattr(vit, name) == getattr(jvit, name), name
    assert vit.use_relative_position_bias and not vit.use_absolute_position_embeddings
    assert [li for li in range(1, 13) if vit.is_global_layer(li)] == [4, 6, 8, 12]
    assert port_vit._rel_pos_num_entries(vit) == 127 ** 2 + 3 == 16132
    # the defaults are the JAX package's (dit-base: absolute, no tables)
    for name in ("use_absolute_position_embeddings", "use_relative_position_bias",
                 "use_shared_relative_position_bias"):
        assert getattr(port_vit.DIT_BASE, name) == getattr(jax_vit.DIT_BASE, name), name


@pytest.mark.parametrize("shared", [False, True])
def test_params_round_trip_with_rel_pos_tables(shared):
    """Tables [16132, 12] per layer (and shared), no pos_embed, at full
    width and the 1024 px grid, 2 of the 12 layers (the shapes repeat):
    JAX tree -> port -> JAX tree unchanged, and the port's own init has
    the same leaves."""
    from layoutdit_tpu.config.constructs import LayoutDitConfig
    from layoutdit_tpu.models.detection.detector import DetectorConfig as JaxDetectorConfig
    from layoutdit_tpu.models.detection.detector import init_detector_params
    from layoutdit_tpu_torch.models.detection.detector import DetectorConfig, init_detector

    with open(CONFIG) as f:
        jm = LayoutDitConfig(**json.load(f)).detection_model_config
    overrides = {**jm.vit_overrides, "num_hidden_layers": 2,
                 "use_shared_relative_position_bias": shared}
    jm = jm.model_copy(update={"vit_overrides": overrides})
    jcfg = JaxDetectorConfig.from_model_config(jm)
    shapes = jax.eval_shape(lambda k: init_detector_params(k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    params = weights_io.params_from_jax(tree)
    vit = params["backbone"]["vit"]
    assert "pos_embed" not in vit and ("shared_rel_pos_table" in vit) == shared
    assert all(layer["rel_pos_table"].shape == (16132, 12) for layer in vit["layers"])
    back = weights_io.params_to_jax(params)
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_b)
    for (path, w), g in zip(flat_j, flat_b):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))

    # the port's init at the same config: the same leaves and shapes, zero tables
    rc = load_run_config(str(CONFIG))
    cfg = DetectorConfig.from_model_config(
        dataclasses.replace(rc.model, vit_overrides=overrides))
    own = init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
    mine = jax.tree_util.tree_flatten_with_path(weights_io.params_to_jax(own))[0]
    assert [(jax.tree_util.keystr(p), w.shape) for p, w in mine] == [
        (jax.tree_util.keystr(p), w.shape) for p, w in flat_j]
    assert not own["backbone"]["vit"]["layers"][0]["rel_pos_table"].any()


def test_inference_cast_keeps_the_tables_in_fp32():
    from layoutdit_tpu_torch.models.detection.detector import params_for_inference

    cfg = port_vit.ViTConfig(**VIT, image_size=64, **TABLES["both"])
    params = port_vit.init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cast = params_for_inference({"vit": params}, torch.bfloat16)["vit"]
    assert cast["shared_rel_pos_table"].dtype == torch.float32
    assert all(layer["rel_pos_table"].dtype == torch.float32 for layer in cast["layers"])
    assert cast["layers"][0]["qkv"]["weight"].dtype == torch.bfloat16


def test_profile_summary_sums_a_stage_over_its_calls():
    """``profile_train`` reports the tables' gradient (a
    ``rel_pos_table_grad`` range per gather, inside the backward) summed
    over its calls: host time of the ranges and the device time of the
    work launched inside them."""
    from layoutdit_tpu_torch.tools.profile_serving import summarize_trace

    ev = [dict(ph="X", name="rel_pos_table_grad", cat="user_annotation", ts=0, dur=10),
          dict(ph="X", name="rel_pos_table_grad", cat="user_annotation", ts=20, dur=10),
          dict(ph="X", name="launch", cat="cuda_runtime", ts=5, dur=1, args={"correlation": 1}),
          dict(ph="X", name="launch", cat="cuda_runtime", ts=25, dur=1, args={"correlation": 2}),
          dict(ph="X", name="launch", cat="cuda_runtime", ts=35, dur=1, args={"correlation": 3}),
          dict(ph="X", name="cuLaunchKernel", cat="cuda_driver", ts=26, dur=1,
               args={"correlation": 4}),
          dict(ph="X", name="k", cat="kernel", ts=30, dur=4, args={"correlation": 1}),
          dict(ph="X", name="k", cat="kernel", ts=40, dur=6, args={"correlation": 2}),
          dict(ph="X", name="k", cat="kernel", ts=50, dur=8, args={"correlation": 3}),
          dict(ph="X", name="gemm", cat="kernel", ts=60, dur=2, args={"correlation": 4})]
    st = summarize_trace({"traceEvents": ev}, ("rel_pos_table_grad",))["stages"]
    # the driver-API launch (cuBLAS's) counts as the runtime's do
    assert st["rel_pos_table_grad"] == {"calls": 2, "host_ms": 0.02, "device_ms": 0.012}



def test_profile_summary_ranks_kernels_by_device_time():
    """``summarize_trace`` ranks kernels by device time summed over their
    calls and keeps the first TOP_KERNELS of them."""
    from layoutdit_tpu_torch.tools import profile_serving as ps

    ev = [dict(ph="X", name=name, cat="kernel", ts=ts, dur=dur)
          for name, ts, dur in (("a", 0, 3), ("b", 5, 4), ("a", 10, 3), ("c", 20, 1))]
    ev += [dict(ph="X", name=f"k{i}", cat="kernel", ts=30 + i, dur=0.5)
           for i in range(ps.TOP_KERNELS)]
    ranked = ps.summarize_trace({"traceEvents": ev}, ())["top_kernels"]
    assert len(ranked) == ps.TOP_KERNELS
    assert [(k["name"], k["calls"], round(k["device_ms"], 9)) for k in ranked[:3]] == [
        ("a", 2, 0.006), ("b", 1, 0.004), ("c", 1, 0.001)]
