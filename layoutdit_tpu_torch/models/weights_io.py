"""Parameters to and from the JAX package's pytree layout.

``params_from_jax`` takes the tree that ``init_detector_params``
(``layoutdit_tpu/models/detection/detector.py``) returns for a
``faster_rcnn``, ``retinanet``, ``fcos`` or ``detr`` DiT detector, as
numpy arrays, and builds the port's
parameter dictionary, so both packages compute the same function;
``params_to_jax`` maps port parameters, or their gradients, back leaf
by leaf:

  * linear kernels are [in, out] in JAX and become [out, in] weights;
  * conv kernels are already OIHW and pass through;
  * separate q / k / v projections become one fused ``qkv`` with a zero
    K bias (BEiT's K has none);
  * fc6 is 4D [Px, Py, C, rep] (RoIAlign's native layout) and becomes
    [rep, Px*Py*C] in the same (px, py, c) order;
  * a cascade model's ``cascade_heads/s{i}`` (a box head and a
    class-agnostic predictor, ``bbox`` [rep, 4] in JAX) map as the box
    head does;
  * the mask head's convs (``fcn1-4``, ``logits``) are OIHW and pass
    through; its transposed conv's JAX kernel [out, in, 2, 2] (OIHW, as
    JAX's ``conv_transpose`` takes it) becomes torch's ``ConvTranspose2d``
    weight [in, out, 2, 2] by transposing dims (0, 1) AND flipping both
    spatial dims: with stride 2, JAX computes out[2i + a] = x[i] W[1 - a]
    where torch computes x[i] W[a]. The transpose alone is not JAX's
    function (``tests/test_torch_mask.py``);
  * a single-stage model has no ``rpn_head``: RetinaNet's
    ``retinanet_head/{cls,reg}/{conv1..4,final}`` and FCOS's
    ``fcos_head/{cls_tower,reg_tower}/conv{i}`` (with ``gn_scale`` and
    ``gn_bias``), ``cls_logits``, ``bbox_reg`` and ``ctrness`` are OIHW
    convs, as torch's, and pass through with no transpose or flip;
  * DETR has no ``rpn_head`` either: ``detr/`` holds ``proj``,
    ``query_embed`` [Q, d] (as it is), ``decoder/layer{i}`` (a list in
    the port) with ``{self_attn,cross_attn}/{in_proj,out_proj}``,
    ``ln1-3``, ``ffn1-2``, then ``decoder_norm``, ``class_head`` and
    ``bbox_mlp/fc1-3``; every linear kernel is transposed, the packed
    ``in_proj`` [d, 3d] becoming [3d, d] with q, k, v in row blocks.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from layoutdit_tpu_torch.utils.flax_msgpack import lists_from_state_dict


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


def tree_paths(tree, prefix: str = "") -> list[str]:
    """The leaves' paths ("backbone/vit/layers/0/qkv/weight"), in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def _linear(p: Mapping, device) -> dict:
    return {"weight": _t(np.asarray(p["kernel"]).T, device), "bias": _t(p["bias"], device)}


def _conv(p: Mapping, device) -> dict:
    return {"weight": _t(p["kernel"], device), "bias": _t(p["bias"], device)}


def _ln(p: Mapping, device) -> dict:
    return {"weight": _t(p["scale"], device), "bias": _t(p["bias"], device)}


def _vit_layer(layer: Mapping, device) -> dict:
    k_bias = layer["k"].get("bias")
    if k_bias is not None and np.any(np.asarray(k_bias) != 0):
        # the fused qkv holds its K-bias slot at zero (k_bias_slots)
        raise ValueError("params_from_jax: a non-zero K bias has no place in the port's "
                         "fused qkv, whose K-bias slot is held at zero")
    q, k, v = (np.asarray(layer[n]["kernel"]) for n in ("q", "k", "v"))
    bq, bv = np.asarray(layer["q"]["bias"]), np.asarray(layer["v"]["bias"])
    out = {
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
    if "rel_pos_table" in layer:
        out["rel_pos_table"] = _t(layer["rel_pos_table"], device)
    return out


# encoder leaves that pass through unchanged, where the model has them:
# position embeddings [1 + P, D] and relative-position tables
# [entries, heads], the same layout in both packages
_VIT_OPTIONAL = ("pos_embed", "shared_rel_pos_table")


def vit_params_from_jax(vit: Mapping, device="cpu") -> dict:
    """JAX ``init_vit_params`` tree (numpy leaves) -> the port's encoder
    params. Windows add no parameters; ``pos_embed`` is [1 + P, D] at the
    configured grid (e.g. [4097, 768] at 1024 px); a relative-position
    table is [(2g-1)^2 + 3, heads] (e.g. [16132, 12] at 1024 px)."""
    out = {
        "cls_token": _t(vit["cls_token"], device),
        "patch_embed": _linear(vit["patch_embed"], device),
    }
    out.update({k: _t(vit[k], device) for k in _VIT_OPTIONAL if k in vit})
    out["layers"] = [_vit_layer(layer, device) for layer in vit["layers"]]
    return out


def _box_head_from_jax(head: Mapping, device) -> dict:
    fc6 = np.asarray(head["fc6"]["kernel"])
    if fc6.ndim != 4:
        raise ValueError("params_from_jax expects fc6 in the 4D native layout")
    rep = fc6.shape[-1]
    return {
        "fc6": {"weight": _t(fc6.reshape(-1, rep).T, device), "bias": _t(head["fc6"]["bias"], device)},
        "fc7": _linear(head["fc7"], device),
    }


def _predictor_from_jax(pred: Mapping, device) -> dict:
    return {n: _linear(pred[n], device) for n in ("cls", "bbox")}


def _numbered(head: Mapping, prefix: str) -> list[str]:
    """A head's numbered convs (``fcn1``.., ``conv1``..) in the order the
    init functions make them (a restored tree may hold its keys sorted)."""
    n = sum(k.startswith(prefix) and k[len(prefix):].isdigit() for k in head)
    return [f"{prefix}{i}" for i in range(1, n + 1)]


def _mask_head_from_jax(head: Mapping, device) -> dict:
    out = {k: _conv(head[k], device) for k in _numbered(head, "fcn")}
    kernel = np.asarray(head["deconv"]["kernel"])  # [out, in, kH, kW]
    out["deconv"] = {"weight": _t(kernel.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1], device),
                     "bias": _t(head["deconv"]["bias"], device)}
    out["logits"] = _conv(head["logits"], device)
    return out


def _gn_conv(p: Mapping, device) -> dict:
    return {**_conv(p, device), "gn_scale": _t(p["gn_scale"], device),
            "gn_bias": _t(p["gn_bias"], device)}


def _retinanet_head_from_jax(head: Mapping, device) -> dict:
    return {sub: {**{k: _conv(head[sub][k], device) for k in _numbered(head[sub], "conv")},
                  "final": _conv(head[sub]["final"], device)}
            for sub in ("cls", "reg")}


_FCOS_OUT = ("cls_logits", "bbox_reg", "ctrness")


def _fcos_head_from_jax(head: Mapping, device) -> dict:
    out = {t: {k: _gn_conv(head[t][k], device) for k in _numbered(head[t], "conv")}
           for t in ("cls_tower", "reg_tower")}
    out.update({k: _conv(head[k], device) for k in _FCOS_OUT})
    return out


def _detr_from_jax(head: Mapping, device) -> dict:
    layers = sorted(head["decoder"].items(), key=lambda kv: int(kv[0][len("layer"):]))
    return {
        "proj": _linear(head["proj"], device),
        "query_embed": _t(head["query_embed"], device),
        "decoder": [{
            **{a: {n: _linear(layer[a][n], device) for n in ("in_proj", "out_proj")}
               for a in ("self_attn", "cross_attn")},
            **{n: _ln(layer[n], device) for n in ("ln1", "ln2", "ln3")},
            **{n: _linear(layer[n], device) for n in ("ffn1", "ffn2")},
        } for _, layer in layers],
        "decoder_norm": _ln(head["decoder_norm"], device),
        "class_head": _linear(head["class_head"], device),
        "bbox_mlp": {n: _linear(head["bbox_mlp"][n], device) for n in ("fc1", "fc2", "fc3")},
    }


def _detr_to_jax(head: dict) -> dict:
    return {
        "proj": _linear_to_jax(head["proj"]),
        "query_embed": _np(head["query_embed"]),
        "decoder": {f"layer{i}": {
            **{a: {n: _linear_to_jax(layer[a][n]) for n in ("in_proj", "out_proj")}
               for a in ("self_attn", "cross_attn")},
            **{n: _ln_to_jax(layer[n]) for n in ("ln1", "ln2", "ln3")},
            **{n: _linear_to_jax(layer[n]) for n in ("ffn1", "ffn2")},
        } for i, layer in enumerate(head["decoder"])},
        "decoder_norm": _ln_to_jax(head["decoder_norm"]),
        "class_head": _linear_to_jax(head["class_head"]),
        "bbox_mlp": {n: _linear_to_jax(head["bbox_mlp"][n]) for n in ("fc1", "fc2", "fc3")},
    }


def params_from_jax(tree: Mapping, device="cpu") -> dict:
    """JAX ``init_detector_params`` tree (numpy leaves) -> port params."""
    fpn = tree["backbone"]["fpn"]
    out = {
        "backbone": {
            "vit": vit_params_from_jax(tree["backbone"]["vit"], device),
            "fpn": {
                "inner": [_conv(p, device) for p in fpn["inner"]],
                "layer": [_conv(p, device) for p in fpn["layer"]],
            },
        },
    }
    if "retinanet_head" in tree:
        out["retinanet_head"] = _retinanet_head_from_jax(tree["retinanet_head"], device)
        return out
    if "fcos_head" in tree:
        out["fcos_head"] = _fcos_head_from_jax(tree["fcos_head"], device)
        return out
    if "detr" in tree:
        out["detr"] = _detr_from_jax(tree["detr"], device)
        return out
    out["rpn_head"] = {n: _conv(tree["rpn_head"][n], device) for n in ("conv", "cls", "bbox")}
    if "cascade_heads" in tree:
        out["cascade_heads"] = {
            name: {"box_head": _box_head_from_jax(st["box_head"], device),
                   "box_predictor": _predictor_from_jax(st["box_predictor"], device)}
            for name, st in sorted(tree["cascade_heads"].items(), key=lambda kv: int(kv[0][1:]))
        }
    else:
        out["box_head"] = _box_head_from_jax(tree["box_head"], device)
        out["box_predictor"] = _predictor_from_jax(tree["box_predictor"], device)
    if "mask_head" in tree:
        out["mask_head"] = _mask_head_from_jax(tree["mask_head"], device)
    return out


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


def _ln_to_jax(p: dict) -> dict:
    return {"scale": _np(p["weight"]), "bias": _np(p["bias"])}


def _conv_to_jax(p: dict) -> dict:
    return {"kernel": _np(p["weight"]), "bias": _np(p["bias"])}


def _vit_layer_to_jax(layer: dict) -> dict:
    w, b = _np(layer["qkv"]["weight"]), _np(layer["qkv"]["bias"])
    d = w.shape[1]
    out = {
        "ln1": _ln_to_jax(layer["ln1"]),
        "ln2": _ln_to_jax(layer["ln2"]),
        "q": {"kernel": w[:d].T, "bias": b[:d]},
        "k": {"kernel": w[d:2 * d].T},
        "v": {"kernel": w[2 * d:].T, "bias": b[2 * d:]},
        "attn_out": _linear_to_jax(layer["attn_out"]),
        "mlp_in": _linear_to_jax(layer["mlp_in"]),
        "mlp_out": _linear_to_jax(layer["mlp_out"]),
        "lambda_1": _np(layer["lambda_1"]),
        "lambda_2": _np(layer["lambda_2"]),
    }
    if "rel_pos_table" in layer:
        out["rel_pos_table"] = _np(layer["rel_pos_table"])
    return out


def vit_params_to_jax(vit: dict) -> dict:
    """The port's encoder params (or their gradients) -> the JAX
    ``init_vit_params`` layout with numpy leaves."""
    out = {"cls_token": _np(vit["cls_token"]), "patch_embed": _linear_to_jax(vit["patch_embed"])}
    out.update({k: _np(vit[k]) for k in _VIT_OPTIONAL if k in vit})
    out["layers"] = [_vit_layer_to_jax(layer) for layer in vit["layers"]]
    return out


def _box_head_to_jax(head: dict, c: int) -> dict:
    fc6 = head["fc6"]
    p = int(round((fc6["weight"].shape[1] // c) ** 0.5))
    return {
        "fc6": {"kernel": _np(fc6["weight"]).T.reshape(p, p, c, -1), "bias": _np(fc6["bias"])},
        "fc7": _linear_to_jax(head["fc7"]),
    }


def _mask_head_to_jax(head: dict) -> dict:
    out = {k: _conv_to_jax(head[k]) for k in _numbered(head, "fcn")}
    w = _np(head["deconv"]["weight"])  # [in, out, kH, kW]
    out["deconv"] = {"kernel": np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(1, 0, 2, 3)),
                     "bias": _np(head["deconv"]["bias"])}
    out["logits"] = _conv_to_jax(head["logits"])
    return out


def params_to_jax(params: dict) -> dict:
    """Port params (or a tree of their gradients, same layout) -> the
    JAX ``init_detector_params`` layout with numpy leaves: the inverse of
    ``params_from_jax``. The fused qkv's K-bias slot has no JAX
    counterpart and is dropped; fc6 goes back to [Px, Py, C, rep], the
    transposed conv's weight back to JAX's flipped OIHW."""
    fpn = params["backbone"]["fpn"]
    c = fpn["layer"][0]["weight"].shape[0]
    out = {
        "backbone": {
            "vit": vit_params_to_jax(params["backbone"]["vit"]),
            "fpn": {
                "inner": [_conv_to_jax(q) for q in fpn["inner"]],
                "layer": [_conv_to_jax(q) for q in fpn["layer"]],
            },
        },
    }
    if "retinanet_head" in params:
        out["retinanet_head"] = {sub: {k: _conv_to_jax(v) for k, v in p.items()}
                                 for sub, p in params["retinanet_head"].items()}
        return out
    if "fcos_head" in params:
        head = params["fcos_head"]
        out["fcos_head"] = {
            **{t: {k: {**_conv_to_jax(v), "gn_scale": _np(v["gn_scale"]),
                       "gn_bias": _np(v["gn_bias"])} for k, v in head[t].items()}
               for t in ("cls_tower", "reg_tower")},
            **{k: _conv_to_jax(head[k]) for k in _FCOS_OUT},
        }
        return out
    if "detr" in params:
        out["detr"] = _detr_to_jax(params["detr"])
        return out
    out["rpn_head"] = {n: _conv_to_jax(params["rpn_head"][n]) for n in ("conv", "cls", "bbox")}
    if "cascade_heads" in params:
        out["cascade_heads"] = {
            name: {"box_head": _box_head_to_jax(st["box_head"], c),
                   "box_predictor": {n: _linear_to_jax(st["box_predictor"][n])
                                     for n in ("cls", "bbox")}}
            for name, st in params["cascade_heads"].items()
        }
    else:
        out["box_head"] = _box_head_to_jax(params["box_head"], c)
        out["box_predictor"] = {n: _linear_to_jax(params["box_predictor"][n])
                                for n in ("cls", "bbox")}
    if "mask_head" in params:
        out["mask_head"] = _mask_head_to_jax(params["mask_head"])
    return out


# ------------------------------------------------ optimizer state and EMA


def _f32(a) -> np.ndarray:
    """A leaf as a float32 numpy array (a bf16 tensor widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _moments_from_jax(tree: Mapping, device) -> list[torch.Tensor]:
    """A moment tree in the JAX parameter layout -> its leaves in the
    port's ``tree_leaves`` order, in the tree's dtype (bf16 or float32)."""
    bf16 = any(isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
               for t in tree_leaves(tree))
    out = tree_leaves(params_from_jax(tree_map(_f32, tree), device))
    return [t.to(torch.bfloat16) for t in out] if bf16 else out


def _count(a, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(a)), dtype=torch.int32, device=device)


def train_state_from_jax(opt_state: Mapping, device="cpu") -> dict:
    """The JAX trainer's optimizer slot, as flax's ``to_state_dict`` gives
    it (numpy leaves, bf16 ones as ``torch.bfloat16``), -> the port's
    (``train/optim.py``; ``{"tx": ..., "ema": ...}`` with an EMA).

    The JAX slot is optax's chain state: ``adamw`` is ``(adam {count,
    mu, nu}, {}, schedule {count})``, behind ``({}, ...)`` with gradient
    clipping, inside ``{notfinite_count, last_finite, total_notfinite,
    inner_state}`` with ``skip_nonfinite_updates``; the trainer wraps it
    as ``{"tx": ..., "ema": ...}`` with an EMA
    (``layoutdit_tpu/train/trainer.py``, ``_ckpt_opt_state``). ``mu`` and
    ``nu`` share the parameters' tree and map through ``params_from_jax``
    (``mu`` keeps its dtype); the counts are int32 scalars. The fused
    qkv's K-bias slot is zero in both moments, as in the parameters
    (``params_from_jax`` raises on a non-zero K bias)."""
    opt_state = lists_from_state_dict(opt_state)
    if isinstance(opt_state, dict) and "ema" in opt_state:
        return {"tx": train_state_from_jax(opt_state["tx"], device),
                "ema": params_from_jax(tree_map(_f32, opt_state["ema"]), device)}
    outer = {}
    chain = opt_state
    if isinstance(chain, dict) and "inner_state" in chain:
        outer = {"notfinite_count": _count(chain["notfinite_count"], device),
                 "total_notfinite": _count(chain["total_notfinite"], device)}
        chain = chain["inner_state"]
    if isinstance(chain, list) and len(chain) == 2 and not chain[0]:
        chain = chain[1]  # clip_by_global_norm's empty state comes first
    if (not isinstance(chain, list) or len(chain) != 3
            or set(chain[0]) != {"count", "mu", "nu"} or chain[1]):
        raise ValueError("train_state_from_jax: not the JAX trainer's adamw chain state")
    adam, schedule = chain[0], chain[2]
    return {
        "mu": _moments_from_jax(adam["mu"], device),
        "nu": _moments_from_jax(adam["nu"], device),
        "count": _count(adam["count"], device),
        "schedule_count": _count(schedule["count"], device),
        **outer,
    }


def _unflatten(template, leaves: list):
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def _check_k_slots_zero(params: dict, leaves: list[torch.Tensor], what: str) -> None:
    tree = _unflatten(params, leaves)
    for i, (bias, k_slot) in enumerate(k_bias_slots(tree)):
        if torch.any(bias.detach()[k_slot] != 0):
            raise ValueError(f"{what}: encoder layer {i}'s K-bias slot is not zero; the JAX "
                             "layout has no K bias to hold it")


def train_state_to_jax(opt_state: dict, params: dict, clip: bool) -> dict:
    """The inverse of ``train_state_from_jax``: the port's optimizer state
    (with its EMA, when it has one) -> the JAX trainer's slot, as flax's
    ``to_state_dict`` writes it, lists and tuples as lists. ``params``
    gives the tree the moments' leaves fill; ``clip`` says whether the
    chain starts with ``clip_by_global_norm`` (``grad_clip_norm`` > 0),
    which the port's state does not record. A bf16 ``mu`` stays bf16, as
    ``torch.bfloat16`` leaves; the counts are int32 0-d arrays."""
    if "ema" in opt_state:
        return {"tx": train_state_to_jax(opt_state["tx"], params, clip),
                "ema": params_to_jax(opt_state["ema"])}

    def moments(leaves, what):
        _check_k_slots_zero(params, leaves, what)
        tree = params_to_jax(_unflatten(params, leaves))
        if leaves[0].dtype == torch.bfloat16:
            tree = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), tree)
        return tree

    def count(t):
        return np.asarray(int(t), dtype=np.int32)

    adam = {"count": count(opt_state["count"]), "mu": moments(opt_state["mu"], "mu"),
            "nu": moments(opt_state["nu"], "nu")}
    state = [adam, {}, {"count": count(opt_state["schedule_count"])}]
    if clip:
        state = [{}, state]
    if "notfinite_count" in opt_state:
        n = int(opt_state["notfinite_count"])
        state = {"notfinite_count": count(n), "last_finite": np.asarray(n == 0),
                 "total_notfinite": count(opt_state["total_notfinite"]), "inner_state": state}
    return state
