"""ViTDet windowed attention in the port vs the JAX package on the CPU,
float32, tiny widths: the partition, merge and key-mask helpers, one
windowed attention layer (forward and gradients) on a divisible and a
padded grid, and the whole encoder with windows (taps and gradients);
plus the config, parameter and fixture plumbing of the windowed 1024 px
training config."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu_torch.config import load_run_config, run_config_from_dict
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models import weights_io

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VIT = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
TAP_TOL = 1e-4
GRAD_RTOL = 1e-3  # relative Frobenius, per leaf


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _jax_vit_params(cfg, seed=0):
    params = jax_vit.init_vit_params(jax.random.PRNGKey(seed), cfg)
    # random (not zero) position embeddings and CLS token, so they count
    params["pos_embed"] = 0.02 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                                   params["pos_embed"].shape)
    params["cls_token"] = 0.02 * jax.random.normal(jax.random.PRNGKey(seed + 2),
                                                   params["cls_token"].shape)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("gh,gw,ws", [(4, 4, 2), (5, 5, 3), (5, 7, 3), (6, 4, 4)])
def test_window_helpers_match_jax(rng, gh, gw, ws):
    x = rng.standard_normal((2, gh * gw, 8)).astype(np.float32)
    want, jdims = jax_vit._window_partition(jnp.asarray(x), gh, gw, ws)
    got, dims = port_vit._window_partition(torch.from_numpy(x), gh, gw, ws)
    assert dims == jdims
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    merged = port_vit._window_merge(got, 2, gh, gw, ws, dims)
    np.testing.assert_array_equal(
        merged.numpy(), np.asarray(jax_vit._window_merge(want, 2, gh, gw, ws, jdims)))
    np.testing.assert_array_equal(merged.numpy(), x)  # the inverse, padding cropped
    jmask, mask = jax_vit._window_key_mask(gh, gw, ws), port_vit._window_key_mask(gh, gw, ws)
    assert (jmask is None) == (mask is None) == (gh % ws == 0 and gw % ws == 0)
    if mask is not None:
        np.testing.assert_array_equal(mask.numpy(), jmask)


@pytest.mark.parametrize("size,ws", [(64, 2), (80, 3)])  # grid 4 divisible; grid 5 padded
def test_windowed_attention_matches_jax(rng, size, ws):
    jcfg = jax_vit.ViTConfig(**VIT, image_size=size, window_size=ws)
    pcfg = port_vit.ViTConfig(**VIT, image_size=size, window_size=ws)
    g = size // 16
    jlayer = _jax_vit_params(jcfg)["layers"][0]
    x = rng.standard_normal((2, 1 + g * g, 64)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    out, vjp = jax.vjp(lambda xx, lay: jax_vit._windowed_attention(xx, lay, jcfg, g, g, None, None),
                       jnp.asarray(x), jlayer)
    jdx, jdlayer = vjp(jnp.asarray(cot))

    layer = weights_io._vit_layer(jlayer, "cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [layer["qkv"]["weight"], layer["qkv"]["bias"], layer["attn_out"]["weight"],
              layer["attn_out"]["bias"]]
    for t in leaves:
        t.requires_grad_(True)
    got = port_vit._windowed_attention(xt, layer, pcfg, g, g)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=FWD_TOL, rtol=FWD_TOL)
    dx, dw, db, dow, dob = torch.autograd.grad(got, [xt] + leaves, torch.from_numpy(cot))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=GRAD_TOL, rtol=GRAD_TOL)
    d = 64
    want_w = np.concatenate([np.asarray(jdlayer[n]["kernel"]).T for n in ("q", "k", "v")])
    np.testing.assert_allclose(dw.numpy(), want_w, atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(db[:d].numpy(), np.asarray(jdlayer["q"]["bias"]), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    np.testing.assert_allclose(db[2 * d:].numpy(), np.asarray(jdlayer["v"]["bias"]),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(dow.numpy(), np.asarray(jdlayer["attn_out"]["kernel"]).T,
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(dob.numpy(), np.asarray(jdlayer["attn_out"]["bias"]),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("size,ws,global_layers", [
    (64, 2, ()),  # the default global layers: the taps 1, 2, 4 of 4; layer 3 windowed
    (80, 3, (2,)),  # a padded grid; layers 1, 3, 4 windowed
    (64, 2, (4,)),
])
def test_vit_forward_with_windows_matches_jax(rng, size, ws, global_layers):
    kw = dict(VIT, image_size=size, window_size=ws, global_attn_layers=global_layers)
    jcfg, pcfg = jax_vit.ViTConfig(**kw), port_vit.ViTConfig(**kw)
    assert [pcfg.is_global_layer(i) for i in range(1, 5)] == [
        jcfg.is_global_layer(i) for i in range(1, 5)]
    jparams = _jax_vit_params(jcfg)
    x = rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    taps = (1, 2, 3, 4)
    g = size // 16
    cots = [rng.standard_normal((2, 1 + g * g, 64)).astype(np.float32) for _ in taps]

    def total(p):
        outs = jax_vit.vit_forward(p, jnp.asarray(x), jcfg, taps=taps)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, want), jgrads = jax.value_and_grad(total, has_aux=True)(jparams)

    params = weights_io.vit_params_from_jax(jparams)
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
    for (path, w), gp in zip(flat_j, flat_p):
        assert gp.shape == w.shape, jax.tree_util.keystr(path)
        assert _rel_frob(gp, w) <= GRAD_RTOL, (jax.tree_util.keystr(path), _rel_frob(gp, w))


@pytest.mark.parametrize("ws", [4, 8])  # equal to the 4 x 4 grid; larger than it
def test_window_covering_the_grid_changes_nothing(rng, ws):
    kw = dict(VIT, image_size=64)
    jparams = _jax_vit_params(jax_vit.ViTConfig(**kw))
    params = weights_io.vit_params_from_jax(jparams)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))
    taps = (1, 2, 3, 4)
    want = port_vit.vit_forward(params, x, port_vit.ViTConfig(**kw), taps=taps)
    got = port_vit.vit_forward(params, x, port_vit.ViTConfig(**kw, window_size=ws), taps=taps)
    for w, g in zip(want, got):
        assert torch.equal(g, w)


def test_padded_window_grid_on_the_card_raises():
    """The short kernels take no key mask, so a padded window grid on a
    device that is not the CPU raises instead of reaching a plain
    version."""
    qkv = torch.empty(2, 9, 3 * 64, device="meta")
    mask = torch.ones(2, 9, dtype=torch.bool, device="meta")
    with pytest.raises(NotImplementedError, match="key mask in the short kernels"):
        port_vit.attention_core(qkv, 4, key_mask=mask)


# ------------------------------------------------- config, weights, fixture


def test_load_run_config_train_1024_window():
    from layoutdit_tpu.config.constructs import LayoutDitConfig

    path = REPO / "configs" / "train_1024_window.json"
    rc = load_run_config(str(path))
    with open(path) as f:
        jc = LayoutDitConfig(**json.load(f))
    jm = jc.detection_model_config
    assert (rc.model.image_size, rc.data.batch_size) == (1024, 4)
    assert (rc.model.window_size, rc.model.window_global_layers) == (16, ())
    assert (rc.model.window_size, list(rc.model.window_global_layers)) == (
        jm.window_size, jm.window_global_layers)
    from layoutdit_tpu_torch.models.detection.detector import DetectorConfig

    vit = DetectorConfig.from_model_config(rc.model, rc.compute_dtype).backbone.vit
    assert (vit.window_size, vit.image_size, vit.grid_size) == (16, 1024, 64)
    assert [li for li in range(1, 13) if vit.is_global_layer(li)] == [4, 6, 8, 12]
    # the ModelConfig defaults are the JAX schema's
    for name in ("window_size", "window_global_layers", "image_size", "attention_impl"):
        jd = getattr(type(jm)(), name)
        pd = getattr(type(rc.model)(), name)
        assert (list(pd) if isinstance(pd, tuple) else pd) == jd, name


@pytest.mark.parametrize("field,value", [("remat", True), ("remat_policy", "dots")])
def test_remat_waits_at_its_default(field, value):
    defaults = {"remat": False, "remat_policy": "full"}
    rc = run_config_from_dict({"detection_model_config": {field: defaults[field]}})
    assert rc.model.window_size == 0
    with pytest.raises(ValueError, match=f"{field}.*activation checkpointing"):
        run_config_from_dict({"detection_model_config": {field: value}})


def test_params_round_trip_at_the_window_config():
    """Windows add no parameters; at 1024 px pos_embed is [4097, 768]."""
    from layoutdit_tpu.models.detection.detector import DetectorConfig as JaxDetectorConfig
    from layoutdit_tpu.models.detection.detector import init_detector_params
    from layoutdit_tpu.config.constructs import LayoutDitConfig

    with open(REPO / "configs" / "train_1024_window.json") as f:
        jm = LayoutDitConfig(**json.load(f)).detection_model_config
    # full width and the 1024 px grid, 2 of the 12 layers (the shapes repeat)
    jm = jm.model_copy(update={"vit_overrides": {"num_hidden_layers": 2}})
    jcfg = JaxDetectorConfig.from_model_config(jm)
    shapes = jax.eval_shape(lambda k: init_detector_params(k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    for layer in tree["backbone"]["vit"]["layers"]:
        assert "bias" not in layer["k"]
    params = weights_io.params_from_jax(tree)
    assert params["backbone"]["vit"]["pos_embed"].shape == (4097, 768)
    back = weights_io.params_to_jax(params)
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_b)
    for (path, w), g in zip(flat_j, flat_b):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_make_fixture_cli_image_size(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "layoutdit_tpu_torch.tools.make_fixture", str(tmp_path),
         "--n", "2", "--image-size", "96"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    with open(tmp_path / "samples.json") as f:
        coco = json.load(f)
    assert [(im["width"], im["height"]) for im in coco["images"]] == [(96, 96)] * 2
    from PIL import Image

    assert Image.open(tmp_path / "samples" / "page_0000.jpg").size == (96, 96)
