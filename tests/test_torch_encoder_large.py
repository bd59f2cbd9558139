"""Encoder coverage in the port against the JAX package on the CPU: the
dit-large preset and the config mapping (``backbone_type``, ``remat``,
``vit_overrides``, the one-device ``mesh_config``), a dit-large-width
encoder cut to 2 layers with activation checkpointing ("full", "dots")
over a padded window grid, the short kernels' plain versions with a key
mask against JAX's masked XLA attention, ``pad_tokens_to``, and the weight
round trip of a 24-layer, 16-head tree. The masked kernels against their
plain versions need the card (marked ``cuda``)."""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import LayoutDitConfig
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection.detector import DetectorConfig as JaxDetectorConfig
from layoutdit_tpu.models.detection.detector import init_detector_params
from layoutdit_tpu_torch import config as port_config
from layoutdit_tpu_torch.config import ModelConfig, run_config_from_dict
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models import weights_io
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.detection.detector import DetectorConfig
from layoutdit_tpu_torch.ops import short_attention as port_short

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FWD_TOL = 1e-4
GRAD_RTOL = 1e-3  # relative Frobenius, per leaf (the JAX-parity tolerance)
SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128)


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _assert_grads_match(jgrads, port_grads_tree):
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jgrads))[0]
    flat_p = jax.tree_util.tree_leaves(port_grads_tree)
    assert len(flat_j) == len(flat_p)
    for (path, w), g in zip(flat_j, flat_p):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert _rel_frob(g, w) <= GRAD_RTOL, (jax.tree_util.keystr(path), _rel_frob(g, w))


def _jax_vit_params(cfg, seed=0):
    params = jax_vit.init_vit_params(jax.random.PRNGKey(seed), cfg)
    # random (not zero) embeddings and tables, so that they count
    for i, name in enumerate(("pos_embed", "cls_token", "shared_rel_pos_table")):
        if name in params:
            params[name] = 0.02 * jax.random.normal(jax.random.PRNGKey(seed + 1 + i),
                                                    params[name].shape)
    for i, layer in enumerate(params["layers"]):
        if "rel_pos_table" in layer:
            layer["rel_pos_table"] = 0.5 * jax.random.normal(
                jax.random.PRNGKey(seed + 10 + i), layer["rel_pos_table"].shape)
    return jax.tree_util.tree_map(np.asarray, params)


# ------------------------------------------------------------ config


def test_presets_match_jax():
    for jp, pp in ((jax_vit.DIT_BASE, port_vit.DIT_BASE), (jax_vit.DIT_LARGE, port_vit.DIT_LARGE)):
        for f in dataclasses.fields(pp):
            assert getattr(pp, f.name) == getattr(jp, f.name), f.name
    assert (port_vit.DIT_LARGE.hidden_size, port_vit.DIT_LARGE.num_hidden_layers,
            port_vit.DIT_LARGE.num_attention_heads, port_vit.DIT_LARGE.head_dim) == (1024, 24, 16, 64)


def _model_sections():
    out = {}
    for name in ("train_1024_large_window14.json", "fsdp_large.json"):
        with open(REPO / "configs" / name) as f:
            out[name] = json.load(f)
    out["large_overrides"] = {"detection_model_config": {
        "backbone_type": "dit-large", "remat": True, "remat_policy": "dots",
        "vit_overrides": {"num_hidden_layers": 6, "pad_tokens_to": 256}}}
    out["large_512_window"] = {"detection_model_config": {
        "backbone_type": "dit-large", "image_size": 512, "window_size": 14,
        "vit_overrides": {"global_attn_layers": [3, 6]}}}
    return out


@pytest.mark.parametrize("name", sorted(_model_sections()))
def test_config_mapping_matches_jax(name):
    """The port's DetectorConfig from a config file against JAX's
    ``DetectorConfig.from_model_config``: every field of the port's
    ViTConfig, the image size and the remat fields."""
    raw = _model_sections()[name]
    jm = LayoutDitConfig(**raw).detection_model_config
    jcfg = JaxDetectorConfig.from_model_config(jm)
    rc = run_config_from_dict(raw)
    cfg = DetectorConfig.from_model_config(rc.model, rc.compute_dtype)
    for f in dataclasses.fields(cfg.backbone.vit):
        assert getattr(cfg.backbone.vit, f.name) == getattr(jcfg.backbone.vit, f.name), f.name
    assert (cfg.image_size, cfg.remat, cfg.remat_policy) == (
        jcfg.image_size, jcfg.remat, jcfg.remat_policy)
    assert (cfg.backbone.taps, cfg.backbone.fpn_out_channels) == (
        jcfg.backbone.taps, jcfg.backbone.fpn_out_channels)


def test_new_config_is_vitdet_l_window14():
    rc = port_config.load_run_config(str(REPO / "configs" / "train_1024_large_window14.json"))
    vit = DetectorConfig.from_model_config(rc.model, rc.compute_dtype).backbone.vit
    assert (rc.model.backbone_type, rc.model.remat, rc.data.batch_size) == ("dit-large", True, 4)
    assert (vit.grid_size, vit.window_size) == (64, 14)
    assert [i for i in range(1, 25) if vit.is_global_layer(i)] == [6, 12, 18, 24]
    # 64 = 4 x 14 + 8: the grid pads to 70 x 70, 25 windows of 196 slots
    mask = port_vit._window_key_mask(64, 64, 14)
    assert tuple(mask.shape) == (25, 196)
    assert int(mask.sum()) == 64 * 64 and bool(mask.any(1).all())


def test_config_refusals_name_what_they_wait_for():
    # resnet50 is ported (models/resnet.py): it loads
    assert run_config_from_dict({"detection_model_config": {
        "backbone_type": "resnet50"}}).model.backbone_type == "resnet50"
    with pytest.raises(ValueError, match="unknown remat_policy 'selective'; use 'full' or 'dots'"):
        ModelConfig(remat=True, remat_policy="selective")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        port_vit.vit_forward({}, torch.zeros(1, 3, 16, 16), port_vit.DIT_BASE, remat_policy="x")
    # bf16 scores and MoE are ported: their overrides load and build
    for key, value in (("score_dtype", "bfloat16"), ("num_experts", 4)):
        mc = ModelConfig(vit_overrides={key: value})
        cfg = DetectorConfig.from_model_config(mc)
        assert getattr(cfg.backbone.vit, key) == value
        layers = port_det.init_detector(cfg, torch.Generator(), "meta")["backbone"]["vit"]
        assert ("router" in layers["layers"][1]) == (key == "num_experts")
    with pytest.raises(ValueError, match="vit_overrides.no_such_field"):
        DetectorConfig.from_model_config(ModelConfig(vit_overrides={"no_such_field": 1}))
    # LoRA is ported: a lora_rank override is an encoder field
    mc = ModelConfig(vit_overrides={"lora_rank": 8})
    assert DetectorConfig.from_model_config(mc).backbone.vit.lora_rank == 8
    # at their JAX defaults they change nothing and load
    mc = ModelConfig(vit_overrides={"score_dtype": "float32", "lora_targets": ["q", "v"]})
    assert DetectorConfig.from_model_config(mc).backbone.vit == port_vit.DIT_BASE


@pytest.mark.parametrize("mesh,cards", [
    ({"data_parallel": -1, "model_parallel": 1, "fsdp": True}, 1),  # fsdp_large.json
    ({"data_parallel": -1}, 0),  # the CPU
    ({"data_parallel": 1, "fsdp": True, "axis_names": ["data", "model"]}, 4),
])
def test_one_device_mesh_loads(monkeypatch, mesh, cards):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    rc = run_config_from_dict({"mesh_config": mesh})
    assert rc.model == ModelConfig()


@pytest.mark.parametrize("mesh,cards,match", [
    ({"data_parallel": -1}, 2, "resolves to 2 devices"),
    ({"data_parallel": 4}, 4, "resolves to 4 devices"),
    ({"data_parallel": 1, "model_parallel": 2}, 1, "model_parallel=2"),
    ({"pipeline_parallel": 2}, 1, "pipeline_parallel=2"),
    ({"sequence_parallel": True}, 1, "sequence_parallel=True"),
    ({"dcn_data_parallel": 2}, 1, "dcn_data_parallel=2"),
    ({"enable_distributed_init": True}, 1, "enable_distributed_init=True"),
    ({"no_such_axis": 1}, 1, "keys not supported"),
])
def test_multi_device_mesh_raises(monkeypatch, mesh, cards, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(ValueError, match=match) as err:
        run_config_from_dict({"mesh_config": mesh})
    if match != "keys not supported":
        assert "queue 1 item 7" in str(err.value)


# ----------------------------------------------- encoder against JAX


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_large_encoder_with_remat_matches_jax(rng, policy):
    """dit-large's widths (hidden 1024, 16 heads, MLP 4096), 2 layers, a
    64 px page in 8 px patches: an 8 x 8 grid in windows of 3, padded to
    9 x 9 (the masked short path), layer 1 windowed and layer 2 global;
    JAX run with ``remat=True`` and the same policy."""
    kw = dict(hidden_size=1024, num_hidden_layers=2, num_attention_heads=16,
              intermediate_size=4096, patch_size=8, image_size=64, window_size=3,
              global_attn_layers=(2,))
    jcfg, pcfg = jax_vit.ViTConfig(**kw), port_vit.ViTConfig(**kw)
    jparams = _jax_vit_params(jcfg)
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    taps = (1, 2)
    cots = [rng.standard_normal((2, 65, 1024)).astype(np.float32) for _ in taps]

    def total(p):
        outs = jax_vit.vit_forward(p, jnp.asarray(x), jcfg, taps=taps, remat=True,
                                   remat_policy=policy)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, want), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(jparams)
    params = weights_io.vit_params_from_jax(jparams)
    for t in weights_io.tree_leaves(params):
        t.requires_grad_(True)
    got = port_vit.vit_forward(params, torch.from_numpy(x), pcfg, taps=taps, remat=True,
                               remat_policy=policy)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), atol=FWD_TOL, rtol=FWD_TOL)
    sum((t * torch.from_numpy(c)).sum() for t, c in zip(got, cots)).backward()
    _assert_grads_match(jgrads, weights_io.vit_params_to_jax(
        weights_io.tree_map(lambda t: t.grad, params)))


def test_zero_cls_gradient_at_jax_init_matches_jax(rng):
    """At JAX's init the CLS token and position embeddings are zero, so the
    CLS row is zero in every layer; a windowed layer isolates it, and each
    LayerNorm of it (eps 1e-12) scales its gradient by 1e6. Both packages
    give the same huge CLS gradient (here 6 narrow layers, 5 windowed, in
    float32: about 4e35), which overflows at dit-large's width; the card's
    ``encoder`` phase therefore trains from drawn embeddings."""
    kw = dict(SMALL, num_hidden_layers=6, patch_size=8, image_size=64, window_size=3,
              global_attn_layers=(6,))
    jcfg, pcfg = jax_vit.ViTConfig(**kw), port_vit.ViTConfig(**kw)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jax_vit.init_vit_params(jax.random.PRNGKey(0), jcfg))
    assert not np.asarray(jparams["cls_token"]).any() and not np.asarray(jparams["pos_embed"]).any()
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    w = np.linspace(-1, 1, 64, dtype=np.float32)
    want = jax.jit(jax.grad(lambda p: (jax_vit.vit_forward(p, jnp.asarray(x), jcfg, taps=(6,))[0]
                                       * w).sum()))(jparams)["cls_token"]
    params = weights_io.vit_params_from_jax(jparams)
    cls = params["cls_token"].requires_grad_(True)
    out = port_vit.vit_forward(params, torch.from_numpy(x), pcfg, taps=(6,))[0]
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), cls)[0].numpy()
    want = np.asarray(want)
    assert np.isfinite(want).all() and np.abs(want).max() > 1e30
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("gh,gw,ws,pages", [
    (5, 5, 3, 2),  # 4 windows of 9 slots a page, the mask read modulo the windows
    (8, 8, 3, 1),  # dit-large test's grid: 9 windows
    (5, 7, 4, 2),  # a grid padded on one side more than the other
])
def test_masked_short_plain_matches_jax(rng, gh, gw, ws, pages):
    """The port's attention with a window key mask (the short kernels'
    plain versions, forward and backward, through their autograd
    Function) against JAX's masked XLA attention (``vit.py:540-564``) and
    ``jax.vjp``; the mask [windows, ws^2] read modulo, as JAX tiles it."""
    cfg = jax_vit.ViTConfig(**SMALL)
    jlayer = _jax_vit_params(cfg)["layers"][0]
    mask = jax_vit._window_key_mask(gh, gw, ws)
    windows, n = mask.shape
    x = rng.standard_normal((pages * windows, n, 64)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    tiled = jnp.tile(jnp.asarray(mask), (pages, 1))
    def fwd_bwd(xx, lay, c):
        out, vjp = jax.vjp(lambda a, b: jax_vit._attention(a, b, cfg, None, impl="xla",
                                                            key_mask=tiled), xx, lay)
        return (out, *vjp(c))

    out, jdx, jdlayer = jax.jit(fwd_bwd)(jnp.asarray(x), jlayer, jnp.asarray(cot))

    layer = weights_io._vit_layer(jlayer, "cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [layer["qkv"]["weight"], layer["qkv"]["bias"]]
    for t in leaves:
        t.requires_grad_(True)
    got = port_vit._attention(xt, layer, port_vit.ViTConfig(**SMALL),
                              key_mask=port_vit._window_key_mask(gh, gw, ws))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    dx, dw, db = torch.autograd.grad(got, [xt] + leaves, torch.from_numpy(cot))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-4, rtol=1e-4)
    want_w = np.concatenate([np.asarray(jdlayer[k]["kernel"]).T for k in ("q", "k", "v")])
    np.testing.assert_allclose(dw.numpy(), want_w, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(db[128:].numpy(), np.asarray(jdlayer["v"]["bias"]), atol=1e-4,
                               rtol=1e-4)


def test_masked_short_plain_drops_keys_exactly(rng):
    """A dropped key gets P = 0: it leaves the output unchanged whatever
    its value, and its dk and dv rows are 0."""
    b, n, h, d = 3, 10, 2, 8
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
                   for _ in range(4))
    mask = torch.ones(1, n, dtype=torch.bool)
    mask[0, 6:] = False
    o = port_short.short_attention(q, k, v, key_mask=mask)
    k2, v2 = k.clone(), v.clone()
    k2[:, 6:], v2[:, 6:] = 100.0, -100.0
    assert torch.equal(o, port_short.short_attention(q, k2, v2, key_mask=mask))
    want = port_short.short_attention_plain(q[:, :6], k[:, :6], v[:, :6])
    # the six real keys alone: the same softmax over fewer columns
    torch.testing.assert_close(o[:, :6], want, atol=1e-6, rtol=1e-6)
    dq, dk, dv = port_short.short_attention_bwd(q, k, v, o, do, key_mask=mask)
    assert not dk[:, 6:].any() and not dv[:, 6:].any()
    assert dq[:, 6:].abs().sum() > 0  # dropped slots are still real query rows


@pytest.mark.parametrize("rel_pos", [False, True])
def test_pad_tokens_to_matches_jax(rng, rel_pos):
    """``pad_tokens_to``: 224 px, 197 tokens padded to 256 at the
    embedding and masked out of every softmax row (with a per-layer
    relative-position table, the bias padded with zeros, as JAX pads it);
    taps 0-2 (cropped) and gradients against JAX's ``vit_forward``."""
    kw = dict(SMALL, image_size=224, pad_tokens_to=256,
              use_relative_position_bias=rel_pos)
    jcfg, pcfg = jax_vit.ViTConfig(**kw), port_vit.ViTConfig(**kw)
    jparams = _jax_vit_params(jcfg)
    x = rng.uniform(-1, 1, (2, 3, 224, 224)).astype(np.float32)
    taps = (0, 1, 2)
    cots = [rng.standard_normal((2, 197, 64)).astype(np.float32) for _ in taps]

    def total(p):
        outs = jax_vit.vit_forward(p, jnp.asarray(x), jcfg, taps=taps)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, want), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(jparams)
    params = weights_io.vit_params_from_jax(jparams)
    for t in weights_io.tree_leaves(params):
        t.requires_grad_(True)
    got = port_vit.vit_forward(params, torch.from_numpy(x), pcfg, taps=taps)
    for w, t in zip(want, got):
        assert t.shape == (2, 197, 64)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), atol=FWD_TOL, rtol=FWD_TOL)
    sum((t * torch.from_numpy(c)).sum() for t, c in zip(got, cots)).backward()
    _assert_grads_match(jgrads, weights_io.vit_params_to_jax(
        weights_io.tree_map(lambda t: t.grad, params)))


def test_pad_tokens_to_with_a_bias_on_the_card_raises():
    """With a bias the padding needs the flash kernels' key mask, which
    they do not take: off the CPU it raises, naming the queue entry."""
    qkv = torch.empty(2, 256, 3 * 64, device="meta")
    mask = torch.ones(1, 256, dtype=torch.bool, device="meta")
    bias = torch.empty(4, 256, 256, device="meta")
    with pytest.raises(NotImplementedError, match="rows 3-6 take no key mask"):
        port_vit.attention_core(qkv, 4, key_mask=mask, bias=bias)
    long_qkv = torch.empty(1, 300, 3 * 64, device="meta")
    with pytest.raises(NotImplementedError, match="rows 3-6 take no key mask"):
        port_vit.attention_core(long_qkv, 4, key_mask=torch.ones(1, 300, dtype=torch.bool,
                                                                   device="meta"))


# -------------------------------------------------------- weights


@pytest.mark.parametrize("overrides", [
    {"hidden_size": 128, "intermediate_size": 256, "use_relative_position_bias": True,
     "use_shared_relative_position_bias": True},  # all 24 layers and 16 heads, narrow
    {"num_hidden_layers": 2},  # full width, 2 of the 24 layers (the shapes repeat)
])
def test_weights_round_trip_dit_large(overrides):
    """``params_from_jax`` / ``params_to_jax`` carry a dit-large tree (24
    layers, 16 heads; tables [entries, 16]) both ways, leaf for leaf."""
    jm = LayoutDitConfig(detection_model_config={
        "backbone_type": "dit-large", "vit_overrides": overrides}).detection_model_config
    jcfg = JaxDetectorConfig.from_model_config(jm)
    shapes = jax.eval_shape(lambda k: init_detector_params(k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                  shapes)
    params = weights_io.params_from_jax(tree)
    vit = params["backbone"]["vit"]
    depth = overrides.get("num_hidden_layers", 24)
    assert len(vit["layers"]) == depth
    width = overrides.get("hidden_size", 1024)
    assert vit["layers"][0]["qkv"]["weight"].shape == (3 * width, width)
    if "rel_pos_table" in vit["layers"][0]:
        assert vit["layers"][0]["rel_pos_table"].shape == ((2 * 14 - 1) ** 2 + 3, 16)
    # the port's own init makes the same tree
    mc = ModelConfig(backbone_type="dit-large", vit_overrides=overrides)
    cfg = DetectorConfig.from_model_config(mc)
    assert cfg.backbone.vit.num_attention_heads == 16
    back = weights_io.params_to_jax(params)
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_b)
    for (path, w), g in zip(flat_j, flat_b):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


# ----------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["window14", "pad256", "first_chunk_dropped"])
def test_masked_short_kernels_match_plain(cuda, rng, case):
    """The masked forward and backward kernels against their plain
    versions (max |plain| / 64, bf16 rounding), dropped keys' dk and dv
    rows exactly 0, and an all-True mask giving the unmasked kernels'
    bits."""
    h, d = 4, 64
    if case == "window14":  # ViTDet-L at 1024 px: 25 windows over 2 pages
        mask = port_vit._window_key_mask(64, 64, 14)
        b = 2 * mask.shape[0]
    elif case == "pad256":  # pad_tokens_to at 224 px
        mask = (torch.arange(256) < 197)[None]
        b = 4
    else:  # a row's first 64-key chunk wholly dropped
        mask = torch.ones(3, 200, dtype=torch.bool)
        mask[:, :70] = False
        b = 6
    mask = mask.to(cuda)
    n = mask.shape[1]
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    q, k, v = port_short.split_qkv(qkv.to(cuda, torch.bfloat16), h)
    do = torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    o = port_short.short_attention(q, k, v, key_mask=mask)
    want = port_short.short_attention_plain(q, k, v, key_mask=mask)
    tol = want.float().abs().max().item() / 64
    assert (o.float() - want.float()).abs().max().item() <= tol
    grads = port_short.short_attention_bwd(q, k, v, o, do, key_mask=mask)
    wants = port_short.short_attention_bwd_plain(q, k, v, o, do, key_mask=mask)
    for g, w in zip(grads, wants):
        assert (g.float() - w.float()).abs().max().item() <= w.float().abs().max().item() / 64
    dropped = ~mask.bool()[torch.arange(b, device=cuda) % mask.shape[0]]  # [B, N]
    for g in grads[1:]:
        assert not g[dropped].any()
    everything = torch.ones_like(mask)
    assert torch.equal(port_short.short_attention(q, k, v, key_mask=everything),
                       port_short.short_attention(q, k, v))
    for g, w in zip(port_short.short_attention_bwd(q, k, v, o, do, key_mask=everything),
                    port_short.short_attention_bwd(q, k, v, o, do)):
        assert torch.equal(g, w)
