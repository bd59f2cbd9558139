"""LoRA adapters for the DiT/BEiT encoder (port of
``layoutdit_tpu/models/lora.py``).

A targeted projection y = x W gains rank-r factors on the side:

    y = x W + (alpha / r) * (x A) B        A: [d_in, r], B: [r, d_out]

with B zero at init, so the adapted model is the pretrained one at step
0. ``A`` and ``B`` keep the JAX package's [d_in, r] / [r, d_out] layout
(the delta is ``x @ A @ B``, as JAX computes it), so they carry between
the packages unchanged.

Where the adapters live: ``attn_out``, ``mlp_in`` and ``mlp_out`` hold
``lora_a`` / ``lora_b`` beside their ``weight`` and ``bias``, as in the
JAX tree. The port's encoder has one fused ``qkv`` projection where JAX
has ``q``, ``k`` and ``v``; their adapters sit beside it, as
``layer["q"] = {"lora_a", "lora_b"}`` (and ``k``, ``v``), and each
delta is added to its third of the fused output (``models/vit.py``),
where JAX concatenates them. A layer's adapters come after its other
entries, in ``LORA_TARGETS`` order, so the leaf order of a tree is the
same however it was built.

The training policy (``trainable_mask``): under ``backbone/vit`` only
the adapters train; everything outside it (FPN, heads) trains.
``merge_lora`` folds (alpha/r) A @ B into the base weights in float32:
the serving and export form, and the one int8 quantization takes.
"""

from __future__ import annotations

import math

import torch

from layoutdit_tpu_torch.models.weights_io import LORA_TARGETS, tree_leaves, tree_paths

QKV = ("q", "k", "v")
LORA_KEYS = ("lora_a", "lora_b")


def _check_targets(targets) -> None:
    unknown = set(targets) - set(LORA_TARGETS)
    if unknown:
        raise ValueError(f"unknown lora_targets {sorted(unknown)}; valid: {LORA_TARGETS}")


def init_lora_entry(d_in: int, d_out: int, rank: int, generator: torch.Generator,
                    device) -> dict:
    """A ~ N(0, 1) truncated to [-2, 2] then / sqrt(r), B = 0: the delta
    starts at exactly zero (the LoRA paper's init, JAX's)."""
    a = torch.empty((d_in, rank), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(a, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
    a = a / math.sqrt(rank)
    return {"lora_a": a, "lora_b": torch.zeros((rank, d_out), dtype=torch.float32,
                                               device=device)}


def _dims(layer: dict, name: str) -> tuple[int, int]:
    """(d_in, d_out) of a target projection: q/k/v are thirds of the fused
    [3D, D] qkv weight; the others are [out, in] weights."""
    if name in QKV:
        d = layer["qkv"]["weight"].shape[1]
        return d, d
    out, d_in = layer[name]["weight"].shape
    return d_in, out


def add_lora_params(vit_params: dict, cfg, generator: torch.Generator) -> dict:
    """A copy of the encoder tree with adapters on the targeted projections
    of every layer, drawn from ``generator``. Refuses to adapt a
    projection twice."""
    if cfg.lora_rank <= 0:
        return vit_params
    _check_targets(cfg.lora_targets)
    device = vit_params["layers"][0]["qkv"]["weight"].device if vit_params["layers"] else "cpu"
    out = dict(vit_params)
    layers = []
    for layer in vit_params["layers"]:
        layer = dict(layer)
        for name in LORA_TARGETS:
            if name not in cfg.lora_targets or (name not in QKV and name not in layer):
                continue  # an MoE layer has no mlp_in / mlp_out (as JAX's)
            if "lora_a" in layer.get(name, {}):
                raise ValueError(f"layer already has LoRA on {name!r}")
            entry = init_lora_entry(*_dims(layer, name), cfg.lora_rank, generator, device)
            layer[name] = entry if name in QKV else {**layer[name], **entry}
        layers.append(layer)
    out["layers"] = layers
    return out


def lora_delta(x: torch.Tensor, p: dict, scale: float) -> torch.Tensor:
    """(alpha/r) (x A) B in x's dtype, rounded as JAX rounds it: h = x A
    (float32 accumulation) rounded to x's dtype, then h B in float32 times
    the scale, rounded once."""
    a = p["lora_a"].to(x.dtype)
    b = p["lora_b"].to(x.dtype)
    h = torch.matmul(x, a)
    return (torch.matmul(h.float(), b.float()) * scale).to(x.dtype)


def merge_lora(vit_params: dict, cfg) -> dict:
    """Fold every adapter into its weight (W += (alpha/r) A B in float32)
    and drop the adapters: the serving and export form, the trained
    model up to one float32 rounding of the sum. q/k/v fold into their
    rows of the fused qkv weight."""
    if cfg.lora_rank <= 0:
        return vit_params
    scale = cfg.lora_scaling
    out = dict(vit_params)
    layers = []
    for layer in vit_params["layers"]:
        layer = dict(layer)
        for name in LORA_TARGETS:
            p = layer.get(name)
            if p is None or "lora_a" not in p:
                continue
            delta = (p["lora_a"].float() @ p["lora_b"].float()) * scale  # [d_in, d_out]
            if name in QKV:
                w = layer["qkv"]["weight"]
                d = w.shape[1]
                rows = slice(QKV.index(name) * d, (QKV.index(name) + 1) * d)
                merged = w.detach().clone()
                merged[rows] = (w[rows].float() + delta.t()).to(w.dtype)
                layer["qkv"] = {**layer["qkv"], "weight": merged}
                del layer[name]
            else:
                w = p["weight"]
                layer[name] = {k: v for k, v in p.items() if k not in LORA_KEYS}
                layer[name]["weight"] = (w.float() + delta.t()).to(w.dtype)
        layers.append(layer)
    out["layers"] = layers
    return out


def has_lora(vit_params: dict) -> bool:
    return any("lora_a" in layer.get(name, {})
               for layer in vit_params.get("layers", ()) for name in LORA_TARGETS)


def merge_lora_detector(params: dict, vit_cfg) -> dict:
    """``merge_lora`` over the encoder of a detector tree (the tree itself
    when it has no adapters)."""
    bb = params.get("backbone", {})
    if "vit" not in bb or not has_lora(bb["vit"]):
        return params
    return {**params, "backbone": {**bb, "vit": merge_lora(bb["vit"], vit_cfg)}}


def trainable_path(path: str) -> bool:
    """The LoRA policy for one leaf path ("backbone/vit/layers/0/q/lora_a"),
    in the port's tree or the JAX one: outside ``backbone/vit`` every leaf
    trains, inside it only the adapters."""
    keys = path.split("/")
    if keys[:2] != ["backbone", "vit"]:
        return True
    return keys[-1] in LORA_KEYS


def trainable_mask(detector_params: dict) -> list[bool]:
    """Per leaf (``tree_leaves`` order), True where the LoRA recipe trains
    it: the encoder (``backbone/vit``) is frozen but for its adapters;
    everything else trains."""
    return [trainable_path(p) for p in tree_paths(detector_params)]


def num_trainable(detector_params: dict) -> tuple[int, int]:
    """(trainable, total) parameter counts under the LoRA policy, as JAX
    counts them: the fused qkv's K-bias slot, which the JAX tree does
    not have (and which is frozen), is left out of the total."""
    leaves = tree_leaves(detector_params)
    trainable = sum(t.numel() for t, m in zip(leaves, trainable_mask(detector_params)) if m)
    total = sum(t.numel() for t in leaves)
    vit = detector_params.get("backbone", {}).get("vit")
    if vit is not None:
        total -= sum(layer["qkv"]["bias"].numel() // 3 for layer in vit["layers"])
    return int(trainable), int(total)
