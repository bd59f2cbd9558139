"""Parameters to and from the JAX package's pytree layout.

``params_from_jax`` takes the tree that ``init_detector_params``
(``layoutdit_tpu/models/detection/detector.py``) returns for a
``faster_rcnn`` DiT detector, as numpy arrays, and builds the port's
parameter dictionary, so both packages compute the same function;
``params_to_jax`` maps port parameters, or their gradients, back leaf
by leaf:

  * linear kernels are [in, out] in JAX and become [out, in] weights;
  * conv kernels are already OIHW and pass through;
  * separate q / k / v projections become one fused ``qkv`` with a zero
    K bias (BEiT's K has none);
  * fc6 is 4D [Px, Py, C, rep] (RoIAlign's native layout) and becomes
    [rep, Px*Py*C] in the same (px, py, c) order.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a parameter tree (nested dicts
    and lists), same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a parameter tree in a fixed order (dict keys in
    insertion order, lists in order)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def _linear(p: Mapping, device) -> dict:
    return {"weight": _t(np.asarray(p["kernel"]).T, device), "bias": _t(p["bias"], device)}


def _conv(p: Mapping, device) -> dict:
    return {"weight": _t(p["kernel"], device), "bias": _t(p["bias"], device)}


def _ln(p: Mapping, device) -> dict:
    return {"weight": _t(p["scale"], device), "bias": _t(p["bias"], device)}


def _vit_layer(layer: Mapping, device) -> dict:
    q, k, v = (np.asarray(layer[n]["kernel"]) for n in ("q", "k", "v"))
    bq, bv = np.asarray(layer["q"]["bias"]), np.asarray(layer["v"]["bias"])
    return {
        "ln1": _ln(layer["ln1"], device),
        "ln2": _ln(layer["ln2"], device),
        "qkv": {
            "weight": _t(np.concatenate([q.T, k.T, v.T], axis=0), device),
            "bias": _t(np.concatenate([bq, np.zeros_like(bq), bv]), device),
        },
        "attn_out": _linear(layer["attn_out"], device),
        "mlp_in": _linear(layer["mlp_in"], device),
        "mlp_out": _linear(layer["mlp_out"], device),
        "lambda_1": _t(layer["lambda_1"], device),
        "lambda_2": _t(layer["lambda_2"], device),
    }


def vit_params_from_jax(vit: Mapping, device="cpu") -> dict:
    """JAX ``init_vit_params`` tree (numpy leaves) -> the port's encoder
    params. Windows add no parameters; ``pos_embed`` is [1 + P, D] at the
    configured grid (e.g. [4097, 768] at 1024 px)."""
    return {
        "cls_token": _t(vit["cls_token"], device),
        "patch_embed": _linear(vit["patch_embed"], device),
        "pos_embed": _t(vit["pos_embed"], device),
        "layers": [_vit_layer(layer, device) for layer in vit["layers"]],
    }


def params_from_jax(tree: Mapping, device="cpu") -> dict:
    """JAX ``init_detector_params`` tree (numpy leaves) -> port params."""
    fpn = tree["backbone"]["fpn"]
    fc6 = np.asarray(tree["box_head"]["fc6"]["kernel"])
    if fc6.ndim != 4:
        raise ValueError("params_from_jax expects fc6 in the 4D native layout")
    rep = fc6.shape[-1]
    return {
        "backbone": {
            "vit": vit_params_from_jax(tree["backbone"]["vit"], device),
            "fpn": {
                "inner": [_conv(p, device) for p in fpn["inner"]],
                "layer": [_conv(p, device) for p in fpn["layer"]],
            },
        },
        "rpn_head": {n: _conv(tree["rpn_head"][n], device) for n in ("conv", "cls", "bbox")},
        "box_head": {
            "fc6": {
                "weight": _t(fc6.reshape(-1, rep).T, device),
                "bias": _t(tree["box_head"]["fc6"]["bias"], device),
            },
            "fc7": _linear(tree["box_head"]["fc7"], device),
        },
        "box_predictor": {
            n: _linear(tree["box_predictor"][n], device) for n in ("cls", "bbox")
        },
    }


def k_bias_slots(params: dict) -> list[tuple[torch.Tensor, slice]]:
    """(fused qkv bias, its K slice) per encoder layer: the slot that has
    no counterpart in the JAX tree (BEiT's K has no bias). It stays zero
    in training: its gradient, zero in exact arithmetic (the softmax is
    invariant to a row-constant shift of the scores), is rounding noise,
    and the trainer holds it at zero (``train/trainer.py``)."""
    slots = []
    for layer in params["backbone"]["vit"]["layers"]:
        bias = layer["qkv"]["bias"]
        d = bias.shape[0] // 3
        slots.append((bias, slice(d, 2 * d)))
    return slots


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _linear_to_jax(p: dict) -> dict:
    return {"kernel": _np(p["weight"]).T, "bias": _np(p["bias"])}


def _conv_to_jax(p: dict) -> dict:
    return {"kernel": _np(p["weight"]), "bias": _np(p["bias"])}


def _vit_layer_to_jax(layer: dict) -> dict:
    w, b = _np(layer["qkv"]["weight"]), _np(layer["qkv"]["bias"])
    d = w.shape[1]
    return {
        "ln1": {"scale": _np(layer["ln1"]["weight"]), "bias": _np(layer["ln1"]["bias"])},
        "ln2": {"scale": _np(layer["ln2"]["weight"]), "bias": _np(layer["ln2"]["bias"])},
        "q": {"kernel": w[:d].T, "bias": b[:d]},
        "k": {"kernel": w[d:2 * d].T},
        "v": {"kernel": w[2 * d:].T, "bias": b[2 * d:]},
        "attn_out": _linear_to_jax(layer["attn_out"]),
        "mlp_in": _linear_to_jax(layer["mlp_in"]),
        "mlp_out": _linear_to_jax(layer["mlp_out"]),
        "lambda_1": _np(layer["lambda_1"]),
        "lambda_2": _np(layer["lambda_2"]),
    }


def vit_params_to_jax(vit: dict) -> dict:
    """The port's encoder params (or their gradients) -> the JAX
    ``init_vit_params`` layout with numpy leaves."""
    return {
        "cls_token": _np(vit["cls_token"]),
        "patch_embed": _linear_to_jax(vit["patch_embed"]),
        "pos_embed": _np(vit["pos_embed"]),
        "layers": [_vit_layer_to_jax(layer) for layer in vit["layers"]],
    }


def params_to_jax(params: dict) -> dict:
    """Port params (or a tree of their gradients, same layout) -> the
    JAX ``init_detector_params`` layout with numpy leaves: the inverse of
    ``params_from_jax``. The fused qkv's K-bias slot has no JAX
    counterpart and is dropped; fc6 goes back to [Px, Py, C, rep]."""
    fpn = params["backbone"]["fpn"]
    fc6 = params["box_head"]["fc6"]
    c = fpn["layer"][0]["weight"].shape[0]
    in_features = fc6["weight"].shape[1]
    p = int(round((in_features // c) ** 0.5))
    return {
        "backbone": {
            "vit": vit_params_to_jax(params["backbone"]["vit"]),
            "fpn": {
                "inner": [_conv_to_jax(q) for q in fpn["inner"]],
                "layer": [_conv_to_jax(q) for q in fpn["layer"]],
            },
        },
        "rpn_head": {n: _conv_to_jax(params["rpn_head"][n]) for n in ("conv", "cls", "bbox")},
        "box_head": {
            "fc6": {
                "kernel": _np(fc6["weight"]).T.reshape(p, p, c, -1),
                "bias": _np(fc6["bias"]),
            },
            "fc7": _linear_to_jax(params["box_head"]["fc7"]),
        },
        "box_predictor": {
            n: _linear_to_jax(params["box_predictor"][n]) for n in ("cls", "bbox")
        },
    }
