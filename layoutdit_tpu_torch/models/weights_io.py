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
  * an MoE layer's ``router`` [D, E], ``moe_in`` [E, D, F] + [E, F] and
    ``moe_out`` [E, F, D] + [E, D] keep JAX's layouts (``kernel`` becomes
    ``weight``), bit for bit;
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
    }
    if "router" in layer:  # an MoE layer: JAX's layouts, as they are
        out["router"] = {"weight": _t(layer["router"]["kernel"], device)}
        for name in ("moe_in", "moe_out"):
            out[name] = {"weight": _t(layer[name]["kernel"], device),
                         "bias": _t(layer[name]["bias"], device)}
    else:
        out["mlp_in"] = _linear(layer["mlp_in"], device)
        out["mlp_out"] = _linear(layer["mlp_out"], device)
    out["lambda_1"] = _t(layer["lambda_1"], device)
    out["lambda_2"] = _t(layer["lambda_2"], device)
    if "rel_pos_table" in layer:
        out["rel_pos_table"] = _t(layer["rel_pos_table"], device)
    # LoRA adapters: [d_in, r] / [r, d_out] in both packages; q/k/v's sit
    # beside the fused qkv, the others inside their projection
    for name in LORA_TARGETS:
        if "lora_a" in layer.get(name, {}):
            entry = {k: _t(layer[name][k], device) for k in ("lora_a", "lora_b")}
            if name in ("q", "k", "v"):
                out[name] = entry
            else:
                out[name].update(entry)
    return out


# the projections LoRA may target (JAX's names, models/lora.py), in the
# order a layer holds their adapters
LORA_TARGETS = ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")

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


_BN = ("weight", "bias", "mean", "var")


def _resnet_from_jax(tree: Mapping, device) -> dict:
    """JAX ``init_resnet50_params`` tree -> the port's: OIHW conv kernels
    (no bias) become ``weight``s, BN statistics pass through."""
    def conv(p):
        return {"weight": _t(p["kernel"], device)}

    def bn(p):
        return {k: _t(p[k], device) for k in _BN}

    def block(b):
        out = {}
        for i in (1, 2, 3):
            out[f"conv{i}"] = conv(b[f"conv{i}"])
            out[f"bn{i}"] = bn(b[f"bn{i}"])
        if "downsample" in b:
            out["downsample"] = {"conv": conv(b["downsample"]["conv"]),
                                 "bn": bn(b["downsample"]["bn"])}
        return out

    return {"stem": {"conv": conv(tree["stem"]["conv"]), "bn": bn(tree["stem"]["bn"])},
            "stages": [[block(b) for b in stage] for stage in tree["stages"]]}


def _resnet_to_jax(tree: dict) -> dict:
    def conv(p):
        return {"kernel": _np(p["weight"])}

    def bn(p):
        return {k: _np(p[k]) for k in _BN}

    def block(b):
        out = {k: conv(v) if k.startswith("conv") else bn(v)
               for k, v in b.items() if k != "downsample"}
        if "downsample" in b:
            out["downsample"] = {"conv": conv(b["downsample"]["conv"]),
                                 "bn": bn(b["downsample"]["bn"])}
        return out

    return {"stem": {"conv": conv(tree["stem"]["conv"]), "bn": bn(tree["stem"]["bn"])},
            "stages": [[block(b) for b in stage] for stage in tree["stages"]]}


def params_from_jax(tree: Mapping, device="cpu") -> dict:
    """JAX ``init_detector_params`` tree (numpy leaves) -> port params.
    A ResNet-50 backbone is ``backbone/{resnet, fpn}`` in both."""
    bb = tree["backbone"]
    fpn = bb["fpn"]
    trunk = ({"resnet": _resnet_from_jax(bb["resnet"], device)} if "resnet" in bb
             else {"vit": vit_params_from_jax(bb["vit"], device)})
    out = {
        "backbone": {
            **trunk,
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
    for layer in params["backbone"].get("vit", {"layers": []})["layers"]:
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
        "lambda_1": _np(layer["lambda_1"]),
        "lambda_2": _np(layer["lambda_2"]),
    }
    if "router" in layer:
        out["router"] = {"kernel": _np(layer["router"]["weight"])}
        for name in ("moe_in", "moe_out"):
            out[name] = {"kernel": _np(layer[name]["weight"]), "bias": _np(layer[name]["bias"])}
    else:
        out["mlp_in"] = _linear_to_jax(layer["mlp_in"])
        out["mlp_out"] = _linear_to_jax(layer["mlp_out"])
    if "rel_pos_table" in layer:
        out["rel_pos_table"] = _np(layer["rel_pos_table"])
    for name in LORA_TARGETS:
        if "lora_a" in layer.get(name, {}):
            out[name].update({k: _np(layer[name][k]) for k in ("lora_a", "lora_b")})
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
    bb = params["backbone"]
    fpn = bb["fpn"]
    c = fpn["layer"][0]["weight"].shape[0]
    trunk = ({"resnet": _resnet_to_jax(bb["resnet"])} if "resnet" in bb
             else {"vit": vit_params_to_jax(bb["vit"])})
    out = {
        "backbone": {
            **trunk,
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


def _fill_masked(tree, like, fill=None):
    """A moment tree in which optax's ``masked`` left a frozen leaf as
    ``MaskedNode`` (``{}`` in flax's state dict), with zeros of the
    parameter's shape there (``like``: the JAX parameter tree); with
    ``fill``, every leaf becomes ``fill(present)`` of that shape."""
    if isinstance(like, dict):
        return {k: _fill_masked(tree[k], v, fill) for k, v in like.items()}
    if isinstance(like, list):
        return [_fill_masked(t, v, fill) for t, v in zip(tree, like, strict=True)]
    present = not isinstance(tree, dict)  # MaskedNode: a frozen leaf has no moment
    if fill is not None:
        return np.broadcast_to(np.float32(fill(present)), np.shape(like))
    return tree if present else np.zeros(np.shape(like), np.float32)


def _moments_from_jax(tree: Mapping, device, trainable: list[bool] | None = None
                      ) -> list[torch.Tensor]:
    """A moment tree in the JAX parameter layout -> its leaves in the
    port's ``tree_leaves`` order (only the ``trainable`` ones, when given),
    in the tree's dtype (bf16 or float32)."""
    bf16 = any(isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
               for t in tree_leaves(tree))
    out = tree_leaves(params_from_jax(tree_map(_f32, tree), device))
    if trainable is not None:
        out = [t for t, m in zip(out, trainable, strict=True) if m]
    return [t.to(torch.bfloat16) for t in out] if bf16 else out


def _count(a, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(a)), dtype=torch.int32, device=device)


def _unmask(chain):
    """optax ``chain(masked(set_to_zero), masked(tx))`` (the JAX trainer's
    LoRA optimizer) -> tx's state, or None when ``chain`` is not that."""
    if (isinstance(chain, list) and len(chain) == 2
            and all(isinstance(c, dict) and set(c) == {"inner_state"} for c in chain)
            and not chain[0]["inner_state"]):
        return chain[1]["inner_state"]
    return None


def train_state_from_jax(opt_state: Mapping, device="cpu", params: Mapping | None = None
                         ) -> dict:
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
    (``params_from_jax`` raises on a non-zero K bias).

    A LoRA run's optimizer (``lora_freeze_base``) is ``chain(masked(
    set_to_zero), masked(adamw chain))``, whose moments hold ``{}`` (optax's
    ``MaskedNode``) at the frozen leaves: the port keeps the moments of
    the trainable leaves only, and their mask over all the leaves as
    ``trainable``. ``params`` (the JAX parameter tree of the same file)
    gives the frozen leaves' shapes."""
    opt_state = lists_from_state_dict(opt_state)
    if isinstance(opt_state, dict) and "ema" in opt_state:
        return {"tx": train_state_from_jax(opt_state["tx"], device, params),
                "ema": params_from_jax(tree_map(_f32, opt_state["ema"]), device)}
    outer = {}
    chain = opt_state
    if isinstance(chain, dict) and "inner_state" in chain:
        outer = {"notfinite_count": _count(chain["notfinite_count"], device),
                 "total_notfinite": _count(chain["total_notfinite"], device)}
        chain = chain["inner_state"]
    inner = _unmask(chain)
    masked = inner is not None
    if masked:
        chain = inner
    if isinstance(chain, list) and len(chain) == 2 and not chain[0]:
        chain = chain[1]  # clip_by_global_norm's empty state comes first
    if (not isinstance(chain, list) or len(chain) != 3
            or set(chain[0]) != {"count", "mu", "nu"} or chain[1]):
        raise ValueError("train_state_from_jax: not the JAX trainer's adamw chain state")
    adam, schedule = chain[0], chain[2]
    mu, nu, trainable = adam["mu"], adam["nu"], None
    if masked:
        if params is None:
            raise ValueError("train_state_from_jax: a masked (LoRA) optimizer state needs "
                             "the parameter tree for its frozen leaves' shapes")
        params = lists_from_state_dict(params)
        # the file's own mask: a port leaf trains where its JAX leaves hold moments
        present = params_from_jax(_fill_masked(mu, params, fill=float), "cpu")
        trainable = [bool(t.any()) for t in tree_leaves(present)]
        mu, nu = _fill_masked(mu, params), _fill_masked(nu, params)
    state = {
        "mu": _moments_from_jax(mu, device, trainable),
        "nu": _moments_from_jax(nu, device, trainable),
        "count": _count(adam["count"], device),
        "schedule_count": _count(schedule["count"], device),
        **outer,
    }
    if trainable is not None:
        state["trainable"] = torch.tensor(trainable, dtype=torch.bool, device=device)
    return state


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


def _mask_jax(tree, keep):
    """A JAX-layout moment tree with ``{}`` (optax's ``MaskedNode`` in
    flax's state dict) at the leaves where ``keep`` (the same layout) is
    false."""
    if isinstance(tree, dict):
        return {k: _mask_jax(v, keep[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_mask_jax(v, m) for v, m in zip(tree, keep, strict=True)]
    return tree if keep else {}


def _trainable_to_jax(params: dict, trainable: list[bool]) -> dict:
    """The port's per-leaf ``trainable`` mask -> one bool per leaf of the
    JAX layout (a JAX leaf trains where its port leaf does)."""
    marks = [torch.tensor(float(m)).expand(p.shape)
             for p, m in zip(tree_leaves(params), trainable, strict=True)]
    return tree_map(lambda a: bool(np.any(a)), params_to_jax(_unflatten(params, marks)))


def train_state_to_jax(opt_state: dict, params: dict, clip: bool) -> dict:
    """The inverse of ``train_state_from_jax``: the port's optimizer state
    (with its EMA, when it has one) -> the JAX trainer's slot, as flax's
    ``to_state_dict`` writes it, lists and tuples as lists. ``params``
    gives the tree the moments' leaves fill; ``clip`` says whether the
    chain starts with ``clip_by_global_norm`` (``grad_clip_norm`` > 0),
    which the port's state does not record. A bf16 ``mu`` stays bf16, as
    ``torch.bfloat16`` leaves; the counts are int32 0-d arrays. A state
    with ``trainable`` (a LoRA run's) becomes JAX's masked chain, ``{}``
    at the frozen leaves."""
    if "ema" in opt_state:
        return {"tx": train_state_to_jax(opt_state["tx"], params, clip),
                "ema": params_to_jax(opt_state["ema"])}
    trainable = opt_state.get("trainable")
    trainable = None if trainable is None else trainable.tolist()
    keep = None if trainable is None else _trainable_to_jax(params, trainable)

    def moments(leaves, what):
        if trainable is not None:  # zeros at the frozen leaves, then {}
            it = iter(leaves)
            leaves = [next(it) if m else torch.zeros_like(p, dtype=leaves[0].dtype)
                      for p, m in zip(tree_leaves(params), trainable, strict=True)]
        _check_k_slots_zero(params, leaves, what)
        tree = params_to_jax(_unflatten(params, leaves))
        if leaves[0].dtype == torch.bfloat16:
            tree = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), tree)
        return _mask_jax(tree, keep) if keep is not None else tree

    def count(t):
        return np.asarray(int(t), dtype=np.int32)

    adam = {"count": count(opt_state["count"]), "mu": moments(opt_state["mu"], "mu"),
            "nu": moments(opt_state["nu"], "nu")}
    state = [adam, {}, {"count": count(opt_state["schedule_count"])}]
    if clip:
        state = [{}, state]
    if trainable is not None:
        state = [{"inner_state": {}}, {"inner_state": state}]
    if "notfinite_count" in opt_state:
        n = int(opt_state["notfinite_count"])
        state = {"notfinite_count": count(n), "last_finite": np.asarray(n == 0),
                 "total_notfinite": count(opt_state["total_notfinite"]), "inner_state": state}
    return state


# ------------------------------------------------------ copying by path


# the encoder leaves a warm start takes from its checkpoint at the
# checkpoint's size, which the forward resamples to the configured grid
RESIZABLE_LEAVES = ("pos_embed", "rel_pos_table", "shared_rel_pos_table")


def _set_path(tree, path: str, value) -> None:
    *parents, last = path.split("/")
    for k in parents:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    tree[int(last) if isinstance(tree, list) else last] = value


def copy_params_(dst: dict, src: dict, resizable: tuple[str, ...] = ()) -> None:
    """Copy ``src``'s tensors into ``dst``'s, in place, matching leaves by
    path: both trees must hold the same paths and shapes. A leaf whose
    last path component is in ``resizable`` may differ in shape (a
    warm-started encoder's position embeddings or relative-position tables
    at the checkpoint's image size): ``dst``'s dict then takes ``src``'s
    tensor in its place. Any other difference raises, copying nothing."""
    dst_leaves = dict(zip(tree_paths(dst), tree_leaves(dst)))
    src_leaves = dict(zip(tree_paths(src), tree_leaves(src)))
    if set(dst_leaves) != set(src_leaves):
        missing = sorted(set(dst_leaves) - set(src_leaves))[:8]
        extra = sorted(set(src_leaves) - set(dst_leaves))[:8]
        raise ValueError(f"parameter trees differ: missing {missing}, unexpected {extra}")
    resized = [k for k, v in src_leaves.items() if dst_leaves[k].shape != v.shape]
    refused = [k for k in resized if k.rsplit("/", 1)[-1] not in resizable]
    if refused:
        raise ValueError("parameter shapes differ: " + ", ".join(
            f"{k} {tuple(src_leaves[k].shape)} against {tuple(dst_leaves[k].shape)}"
            for k in refused[:8]))
    with torch.no_grad():
        for k, v in src_leaves.items():
            if k in resized:
                _set_path(dst, k, v)
            else:
                dst_leaves[k].copy_(v)


# ----------------------------------------- pretrained DiT/BEiT checkpoints

# HF BeitModel parameter names (prefix-stripped)
_EMB = "embeddings."
_LAYER = "encoder.layer.{i}."
# the prefixes a BEiT state_dict's keys may carry (JAX weights_io.py)
_PREFIXES = ("beit.", "dit.", "model.", "backbone.backbone.dit.")


def _as_np(t) -> np.ndarray:
    """A torch tensor or array -> float32 numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def beit_state_dict_to_params(state_dict: Mapping, cfg, device="cpu") -> dict:
    """An HF ``BeitModel`` state_dict -> the port's encoder tree (port of
    JAX ``beit_state_dict_to_params``): keys with or without a ``beit.`` /
    ``dit.`` / ``model.`` prefix; pooler, final LayerNorm, mask token and
    LM-head weights are ignored. ``query`` / ``key`` / ``value`` rows go
    straight into the fused ``qkv`` weight's rows ([out, in], as torch's);
    the fused bias is [query bias, 0, value bias] (BEiT's key has none).
    The patch projection's conv [D, C, p, p] is the linear [D, C*p*p] in
    ``patchify``'s (c, kh, kw) order. Layer scales and relative-position
    tables come along where present; a layer without layer scales gets
    ones (the same function)."""
    sd = {}
    for k, v in state_dict.items():
        for pre in _PREFIXES:
            if k.startswith(pre):
                k = k[len(pre):]
        sd[k] = v

    def take(name: str) -> torch.Tensor:
        return _t(_as_np(sd[name]), device)

    d = cfg.hidden_size
    conv_w = take(_EMB + "patch_embeddings.projection.weight")
    params = {
        "cls_token": take(_EMB + "cls_token").reshape(d),
        "patch_embed": {"weight": conv_w.reshape(d, -1).contiguous(),
                        "bias": take(_EMB + "patch_embeddings.projection.bias")},
    }
    if _EMB + "position_embeddings" in sd:
        params["pos_embed"] = take(_EMB + "position_embeddings").reshape(-1, d)
    shared = "encoder.relative_position_bias.relative_position_bias_table"
    if shared in sd:
        params["shared_rel_pos_table"] = take(shared)
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = _LAYER.format(i=i)
        att = p + "attention.attention."
        bq = take(att + "query.bias")

        def lin(name):
            return {"weight": take(name + ".weight"), "bias": take(name + ".bias")}

        layer = {
            "ln1": lin(p + "layernorm_before"),
            "ln2": lin(p + "layernorm_after"),
            "qkv": {
                "weight": torch.cat([take(att + "query.weight"), take(att + "key.weight"),
                                     take(att + "value.weight")], dim=0),
                "bias": torch.cat([bq, torch.zeros_like(bq), take(att + "value.bias")]),
            },
            "attn_out": lin(p + "attention.output.dense"),
            "mlp_in": lin(p + "intermediate.dense"),
            "mlp_out": lin(p + "output.dense"),
        }
        for lam in ("lambda_1", "lambda_2"):
            layer[lam] = take(p + lam) if p + lam in sd else torch.ones(d, device=device)
        rel = att + "relative_position_bias.relative_position_bias_table"
        if rel in sd:
            layer["rel_pos_table"] = take(rel)
        layers.append(layer)
    params["layers"] = layers
    return params


def load_beit_checkpoint(path: str, cfg, device="cpu") -> dict:
    """A DiT/BEiT encoder checkpoint (local or a ``scheme://`` URL) -> the
    port's encoder tree: an HF state_dict as ``.bin`` / ``.pth``
    (``torch.load(weights_only=True)``) or ``.safetensors`` (needs the
    ``safetensors`` package), or a converted ``.msgpack`` written by
    either package's ``tools/convert_hf_checkpoint.py``. Into an encoder
    with experts (``num_experts`` > 0), as the JAX package's loader: a
    ``.msgpack`` without them raises; an HF state_dict gives its dense
    encoder, every layer with ``mlp_in`` / ``mlp_out`` and no router."""
    from layoutdit_tpu_torch.utils.paths import open_path, read_bytearray

    if path.endswith(".msgpack"):
        buf = read_bytearray(path)
        magic = b"LDTPU1\n"
        if not buf.startswith(magic):
            raise ValueError(f"{path} is not a layoutdit_tpu checkpoint")
        from layoutdit_tpu_torch.utils.flax_msgpack import loads

        raw = lists_from_state_dict(loads(memoryview(buf)[len(magic):]))
        vit = vit_params_from_jax(raw["params"], device)
        missing = [i for i, layer in enumerate(vit["layers"], start=1)
                   if cfg.is_moe_layer(i) and "router" not in layer]
        if missing:
            # JAX's loader reads the file into its config's template, which
            # has the experts: it refuses the file the same way
            raise ValueError(f"{path}: the encoder checkpoint has no experts in layers "
                             f"{missing}, where the config (num_experts={cfg.num_experts}) "
                             "has them")
        return vit
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load as st_load
        except ImportError as e:
            raise ImportError(f"{path}: reading .safetensors needs the safetensors package; "
                              "convert the checkpoint to .pth or .msgpack elsewhere") from e
        sd = st_load(bytes(read_bytearray(path)))
    else:
        with open_path(path, "rb") as f:
            sd = torch.load(f, map_location="cpu", weights_only=True)
    return beit_state_dict_to_params(sd, cfg, device)


# ------------------------------------------- reference detector checkpoints


def _ref_conv(sd: Mapping, device, *names: str) -> dict:
    """The first present conv (torchvision renamed its containers across
    versions: plain Conv2d vs Conv2dNormActivation's ``.0``)."""
    for name in names:
        if name + ".weight" in sd:
            return {"weight": _t(_as_np(sd[name + ".weight"]), device),
                    "bias": _t(_as_np(sd[name + ".bias"]), device)}
    raise KeyError(f"none of {names} in state_dict")


def detector_state_dict_to_params(state_dict: Mapping, cfg, device="cpu") -> dict:
    """A reference full-detector checkpoint (torch ``LayoutDetectionModel.
    state_dict()``: torchvision FasterRCNN over the DiT + FPN backbone) ->
    the port's detector tree (port of JAX ``detector_state_dict_to_params``):
    the encoder under ``backbone.backbone.dit.``, the FPN, the RPN head,
    the box head and the predictor. Linear weights are [out, in] in both;
    fc6's columns go from torch's (c, py, px) flattening to the port's
    (px, py, c). A cascade config is refused (its heads have no source
    weights); shapes are checked against the config's tree."""
    from layoutdit_tpu_torch.models.detection.detector import init_detector

    if cfg.cascade_iou_threshs:
        raise ValueError("reference checkpoints are plain Faster R-CNN; target a non-cascade "
                         "config (cascade heads have no source weights)")
    sd = {}
    for k, v in state_dict.items():
        for pre in ("module.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
        sd[k] = v
    enc = "backbone.backbone.dit."
    enc_sd = {k[len(enc):]: v for k, v in sd.items() if k.startswith(enc)}
    if not enc_sd:
        raise ValueError("no DiT encoder weights under backbone.backbone.dit.* — not a "
                         "reference detector checkpoint?")

    def lin(name):
        return {"weight": _t(_as_np(sd[name + ".weight"]), device),
                "bias": _t(_as_np(sd[name + ".bias"]), device)}

    c = cfg.backbone.fpn_out_channels
    p = cfg.roi_output_size
    w6 = _as_np(sd["roi_heads.box_head.fc6.weight"])  # [rep, C*P*P], (c, py, px)
    rep = w6.shape[0]
    if w6.shape[1] != c * p * p:
        raise ValueError(f"fc6 expects {c}x{p}x{p} pooled features (fpn_out_channels x "
                         f"roi_output_size^2) but the checkpoint has in_features="
                         f"{w6.shape[1]} — config mismatch")
    params = {
        "backbone": {
            "vit": beit_state_dict_to_params(enc_sd, cfg.backbone.vit, device),
            "fpn": {
                "inner": [_ref_conv(sd, device, f"backbone.fpn.inner_blocks.{i}.0",
                                    f"backbone.fpn.inner_blocks.{i}") for i in range(4)],
                "layer": [_ref_conv(sd, device, f"backbone.fpn.layer_blocks.{i}.0",
                                    f"backbone.fpn.layer_blocks.{i}") for i in range(4)],
            },
        },
        "rpn_head": {
            "conv": _ref_conv(sd, device, "rpn.head.conv.0.0", "rpn.head.conv"),
            "cls": _ref_conv(sd, device, "rpn.head.cls_logits"),
            "bbox": _ref_conv(sd, device, "rpn.head.bbox_pred"),
        },
        "box_head": {
            "fc6": {"weight": _t(w6.reshape(rep, c, p, p).transpose(0, 3, 2, 1)
                                 .reshape(rep, -1), device),
                    "bias": _t(_as_np(sd["roi_heads.box_head.fc6.bias"]), device)},
            "fc7": lin("roi_heads.box_head.fc7"),
        },
        "box_predictor": {"cls": lin("roi_heads.box_predictor.cls_score"),
                          "bbox": lin("roi_heads.box_predictor.bbox_pred")},
    }
    template = init_detector(cfg, torch.Generator(), device="meta")
    want = dict(zip(tree_paths(template), tree_leaves(template)))
    got = dict(zip(tree_paths(params), tree_leaves(params)))
    errors = [f"missing {k}" for k in want if k not in got]
    errors += [f"{k}: {tuple(got[k].shape)} != {tuple(v.shape)}" for k, v in want.items()
               if k in got and got[k].shape != v.shape]
    errors += [f"unexpected {k}" for k in got if k not in want][:8]
    if errors:
        raise ValueError("converted checkpoint does not match the target config: "
                         + "; ".join(errors[:12])
                         + (f"; +{len(errors) - 12} more" if len(errors) > 12 else "")
                         + f" (leaves: {len(got)} vs {len(want)})")
    return params
