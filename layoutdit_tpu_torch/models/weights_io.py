"""Parameters from the JAX package's pytree layout.

``params_from_jax`` takes the tree that ``init_detector_params``
(``layoutdit_tpu/models/detection/detector.py``) returns for a
``faster_rcnn`` DiT detector, as numpy arrays, and builds the port's
parameter dictionary, so both packages compute the same function:

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


def params_from_jax(tree: Mapping, device="cpu") -> dict:
    """JAX ``init_detector_params`` tree (numpy leaves) -> port params."""
    vit = tree["backbone"]["vit"]
    fpn = tree["backbone"]["fpn"]
    fc6 = np.asarray(tree["box_head"]["fc6"]["kernel"])
    if fc6.ndim != 4:
        raise ValueError("params_from_jax expects fc6 in the 4D native layout")
    rep = fc6.shape[-1]
    return {
        "backbone": {
            "vit": {
                "cls_token": _t(vit["cls_token"], device),
                "patch_embed": _linear(vit["patch_embed"], device),
                "pos_embed": _t(vit["pos_embed"], device),
                "layers": [_vit_layer(layer, device) for layer in vit["layers"]],
            },
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
