"""The mixture-of-experts encoder in the port (``ops/moe.py``, the MoE
layers of ``models/vit.py``, ``loss_moe_aux`` in
``models/detection/detector.py``) against the JAX package on the CPU,
float32, tiny widths, the same seeded numpy inputs and weights carried by
``params_from_jax``.

Tolerances: ``moe_mlp`` outputs and the load-balance loss 1e-5, its
gradients 1e-4, the routing (experts, kept slots) equal; the encoder's
taps 1e-5, ``moe_aux`` 1e-6, every gradient leaf 1e-4 relative Frobenius;
remat "full" and "dots" the same bits as remat off. The detector, its
weights, checkpoints and export: ``test_torch_moe_detector.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.ops import moe as jax_moe
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.weights_io import (
    tree_leaves,
    tree_map,
    tree_paths,
    vit_params_from_jax,
    vit_params_to_jax,
)
from layoutdit_tpu_torch.ops import moe as port_moe

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

OUT_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-4
MOE = dict(num_experts=4, moe_every_n=1, moe_capacity_factor=1.0)
VIT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
           image_size=64)


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _moe_params(d=16, f=32, e=4, seed=0):
    """JAX's init with a random router and random biases (so that each
    counts), numpy leaves."""
    p = jax.tree_util.tree_map(np.asarray,
                               jax_moe.init_moe_mlp_params(jax.random.PRNGKey(seed), d, f, e))
    rng = np.random.default_rng(seed + 1)
    p["router"]["kernel"] = rng.standard_normal((d, e)).astype(np.float32)
    for name in ("moe_in", "moe_out"):
        p[name]["bias"] = (0.1 * rng.standard_normal(p[name]["bias"].shape)).astype(np.float32)
    return p


def _port_moe_params(p):
    return {"router": {"weight": torch.tensor(p["router"]["kernel"], requires_grad=True)},
            **{n: {"weight": torch.tensor(p[n]["kernel"], requires_grad=True),
                   "bias": torch.tensor(p[n]["bias"], requires_grad=True)}
               for n in ("moe_in", "moe_out")}}


def test_capacity_matches_jax():
    for tokens, e, k, cf in ((197, 8, 1, 1.25), (4097, 8, 1, 1.25), (13, 4, 2, 0.5),
                             (3, 8, 2, 0.1), (17, 4, 1, 2.0)):
        assert port_moe.moe_capacity(tokens, e, k, cf) == jax_moe.moe_capacity(tokens, e, k, cf)
    assert port_moe.moe_capacity(4097, 8, 1, 1.25) == 641  # the 1024 px bucket's


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 1.25), (1, 0.5), (2, 1.0), (2, 0.5)])
def test_moe_mlp_matches_jax(top_k, capacity_factor):
    """Outputs, the aux loss, the routing and the gradients into the input
    and every parameter; capacity factor 0.5 drops tokens at top-1 and
    top-2 (their rows zero at top-1)."""
    e = 4
    p = _moe_params(e=e)
    y = np.random.default_rng(4).standard_normal((2, 13, 16)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal((2, 13, 16)).astype(np.float32)

    def jloss(y, p):
        out, aux = jax_moe.moe_mlp(y, p, e, top_k, capacity_factor)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (jout, jaux)), (jgy, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), p)
    tp = _port_moe_params(p)
    ty = torch.tensor(y, requires_grad=True)
    out, aux = port_moe.moe_mlp(ty, tp, e, top_k, capacity_factor)
    ((out * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=AUX_TOL, atol=AUX_TOL)
    # the routing: JAX's argmax choice, and its zero rows where a top-1
    # token was dropped
    c = port_moe.moe_capacity(13, e, top_k, capacity_factor)
    experts, _, _, kept, _ = port_moe.route(ty.detach(), tp["router"]["weight"].detach(), e,
                                            top_k, c)
    probs = jax.nn.softmax(jnp.asarray(y) @ p["router"]["kernel"], axis=-1)
    np.testing.assert_array_equal(experts[0].numpy(), np.asarray(jnp.argmax(probs, -1)))
    if top_k == 1:
        dropped = np.all(np.asarray(jout) == 0, axis=-1)
        np.testing.assert_array_equal(~kept[0].numpy(), dropped)
        assert dropped.any() or capacity_factor >= 1
    else:
        assert bool((~kept[1]).any()) or capacity_factor >= 1
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tp["router"]["weight"].grad.numpy(),
                               np.asarray(jgp["router"]["kernel"]), rtol=GRAD_TOL, atol=GRAD_TOL)
    for name in ("moe_in", "moe_out"):
        for leaf, key in (("weight", "kernel"), ("bias", "bias")):
            np.testing.assert_allclose(tp[name][leaf].grad.numpy(),
                                       np.asarray(jgp[name][key]), rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=f"{name}/{leaf}")


def test_single_expert_is_the_dense_mlp_and_init_layout():
    """E = 1 at top-1 is the dense GELU MLP (probability 1, capacity >= S)
    with aux 1; the init draws JAX's shapes, truncated at 2 std, zero
    biases."""
    gen = torch.Generator().manual_seed(0)
    p = port_moe.init_moe_mlp_params(16, 32, 1, gen, "cpu", initializer_range=0.5)
    assert [tuple(t.shape) for t in tree_leaves(p)] == [(16, 1), (1, 16, 32), (1, 32),
                                                        (1, 32, 16), (1, 16)]
    assert float(p["moe_in"]["weight"].abs().max()) <= 1.0 and not p["moe_in"]["bias"].any()
    p["moe_in"]["bias"] = torch.randn(1, 32, generator=gen)
    y = torch.randn(2, 11, 16, generator=gen)
    out, aux = port_moe.moe_mlp(y, p, 1, 1, 2.0)
    h = torch.nn.functional.gelu(y @ p["moe_in"]["weight"][0] + p["moe_in"]["bias"][0])
    torch.testing.assert_close(out, h @ p["moe_out"]["weight"][0] + p["moe_out"]["bias"][0],
                               rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(1.0, abs=1e-6)


LAYOUTS = {
    "dense": dict(patch_size=16),
    # 8 x 8 grid in windows of 3: padded windows, the CLS alone; the
    # second layer global
    "windowed": dict(patch_size=8, window_size=3, global_attn_layers=(2,)),
    "relpos": dict(patch_size=16, use_absolute_position_embeddings=False,
                   use_relative_position_bias=True),
}


def _jax_encoder(layout: str, **extra):
    cfg = jax_vit.ViTConfig(**VIT, **MOE, **LAYOUTS[layout], **extra)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_vit.init_vit_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    if "pos_embed" in params:
        params["pos_embed"] = (0.02 * rng.standard_normal(params["pos_embed"].shape)
                               ).astype(np.float32)
    for layer in params["layers"]:
        if "rel_pos_table" in layer:
            layer["rel_pos_table"] = (0.5 * rng.standard_normal(layer["rel_pos_table"].shape)
                                      ).astype(np.float32)
        if "router" in layer:  # a router that spreads the tokens
            layer["router"]["kernel"] = rng.standard_normal(
                layer["router"]["kernel"].shape).astype(np.float32)
    return cfg, params


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_encoder_with_moe_layers_matches_jax(layout):
    """Both layers MoE (moe_every_n 1, capacity factor 1.0): the taps, the
    summed ``moe_aux`` and every gradient leaf."""
    jcfg, jparams = _jax_encoder(layout)
    pcfg = port_vit.ViTConfig(**VIT, **MOE, **LAYOUTS[layout])
    params = vit_params_from_jax(jparams)
    assert all("router" in layer and "mlp_in" not in layer for layer in params["layers"])
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(np.float32)
    n = (64 // pcfg.patch_size) ** 2 + 1
    r = [np.random.default_rng(3 + i).standard_normal((2, n, 32)).astype(np.float32)
         for i in range(2)]

    def jloss(p):
        aux_out = {}
        taps = jax_vit.vit_forward(p, jnp.asarray(x), jcfg, taps=(1, 2), aux_out=aux_out)
        return sum(jnp.sum(t * w) for t, w in zip(taps, r)) + aux_out["moe_aux"], (
            taps, aux_out["moe_aux"])

    (_, (jtaps, jaux)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    aux_out = {}
    taps = port_vit.vit_forward(params, torch.from_numpy(x), pcfg, taps=(1, 2), aux_out=aux_out)
    (sum((t * torch.from_numpy(w)).sum() for t, w in zip(taps, r)) + aux_out["moe_aux"]
     ).backward()
    for got, want in zip(taps, jtaps):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=OUT_TOL,
                                   atol=OUT_TOL)
    np.testing.assert_allclose(float(aux_out["moe_aux"]), float(jaux), rtol=AUX_TOL)
    assert float(jaux) >= 2.0 - 1e-5  # two MoE layers, each >= 1
    grads = vit_params_to_jax(tree_map(lambda t: t.grad, params))
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jgrads))[0]
    flat_p = jax.tree_util.tree_leaves(grads)
    assert len(flat_j) == len(flat_p)
    for (path, w), g in zip(flat_j, flat_p):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert _rel_frob(g, w) <= GRAD_TOL, (jax.tree_util.keystr(path), _rel_frob(g, w))


def test_moe_every_n_and_pad_tokens_guard():
    """Layers 2 and 4 of 4 are MoE at moe_every_n 2, as JAX's init places
    them; ``pad_tokens_to`` stays off with experts (the taps keep 17
    tokens, the same function as without it)."""
    cfg = port_vit.ViTConfig(**{**VIT, "num_hidden_layers": 4}, num_experts=4)
    jcfg = jax_vit.ViTConfig(**{**VIT, "num_hidden_layers": 4}, num_experts=4)
    assert [cfg.is_moe_layer(i) for i in range(1, 5)] == [jcfg.is_moe_layer(i)
                                                         for i in range(1, 5)]
    params = port_vit.init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax_vit.init_vit_params(jax.random.PRNGKey(0), jcfg)
    assert [sorted(layer) for layer in params["layers"]] == [
        sorted(vit_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))["layers"][i])
        for i in range(4)]
    assert tuple(params["layers"][1]["moe_in"]["weight"].shape) == (4, 32, 64)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 64, 64))
                         .astype(np.float32))
    padded = port_vit.ViTConfig(**{**VIT, "num_hidden_layers": 4}, num_experts=4,
                                pad_tokens_to=32)
    want = port_vit.vit_forward(params, x, cfg, taps=(4,))[0]
    got = port_vit.vit_forward(params, x, padded, taps=(4,))[0]
    assert got.shape == (2, 17, 32) and torch.equal(got, want)


def _encoder_grads(params, cfg, x, remat, policy):
    leaves = tree_leaves(params)
    for t in leaves:
        t.grad = None
        t.requires_grad_(True)
    aux_out = {}
    taps = port_vit.vit_forward(params, x, cfg, taps=(1, 2), remat=remat, remat_policy=policy,
                                aux_out=aux_out)
    (sum(t.square().sum() for t in taps) + aux_out["moe_aux"]).backward()
    return [t.grad.clone() for t in leaves]


def test_remat_arms_give_the_gradients_of_remat_off():
    """``remat`` "full" and "dots" over MoE layers: the same gradient bits
    as remat off, the router's product among the saved ones under "dots"
    (an ``aten.mm``), the experts' batched products recomputed."""
    _, jparams = _jax_encoder("dense")
    cfg = port_vit.ViTConfig(**VIT, **MOE, **LAYOUTS["dense"])
    params = vit_params_from_jax(jparams)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 64, 64))
                         .astype(np.float32))
    ref = _encoder_grads(params, cfg, x, False, "full")
    names = tree_paths(params)
    for policy in ("full", "dots"):
        got = _encoder_grads(params, cfg, x, True, policy)
        for name, a, b in zip(names, ref, got):
            assert torch.equal(a, b), (policy, name)
    assert port_vit._dots_policy(None, torch.ops.aten.mm.default).name == "MUST_SAVE"
    assert port_vit._dots_policy(None, torch.ops.aten.baddbmm.default).name == \
        "PREFER_RECOMPUTE"
