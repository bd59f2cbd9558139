"""Int8 weights with dynamic int8 activations (W8A8) for the serving path
(port of ``layoutdit_tpu/ops/quant.py``).

  * weights: symmetric int8 per output channel, quantized once
    (``quantize_vit_params``). JAX quantizes a [K, N] kernel per column;
    the port's [N, K] weight is quantized per row, the same channels.
    The fused qkv's row scales are q's, k's and v's, concatenated, as
    JAX concatenates them;
  * activations: symmetric int8 per row (token), absmax / 127, computed
    at each call, in JAX's order: ``round(x / s)`` (half to even on both
    sides), clipped to +-127;
  * the s8 x s8 -> s32 product is ``torch._int_mm`` (JAX's
    ``dot_general`` with an int32 result, outside any Pallas kernel),
    exact in int32 at these sizes (|q| <= 127, K <= 4096), then
    ``y.float() * x_scale * w_scale`` (+ bias) and the cast back.

A quantized linear holds ``weight_q`` (int8 [N, K]), ``weight_scale``
(float32 [N]) and its ``bias``; ``models/vit.py`` dispatches on
``weight_q``. Serving only: there is no backward, and a call that autograd
would record raises. On a CUDA tensor ``_int_mm`` takes more than 16
rows and K and N multiples of 8; outside that the call raises (the
weight's ``.t()`` is the column-major second operand it needs).
"""

from __future__ import annotations

import torch

# the linears of a ViT layer, by JAX's names
VIT_LINEAR_KEYS = ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")
# JAX's default subset (its measurement, on a TPU, of where int8 paid)
VIT_INT8_DEFAULT_KEYS = ("q", "k", "v", "mlp_in")


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, K] float -> (int8 [N, K], float32 scale [N]), per row."""
    w = w.detach().float()
    scale = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_linear(p: dict) -> dict:
    """``{"weight" [N, K], "bias"?}`` -> ``{"weight_q", "weight_scale",
    "bias"?}``. Unmerged adapters raise: quantizing would drop them."""
    if "lora_a" in p:
        raise ValueError("unmerged LoRA adapters would be silently dropped by int8 "
                         "quantization; fold them first (models/lora.py merge_lora)")
    q, scale = quantize_weight(p["weight"])
    out = {"weight_q": q, "weight_scale": scale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: [..., K] -> (int8 [..., K], float32 [..., 1])."""
    x = x.float()
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def _int_mm(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [N, K]^T -> int32 [M, N]."""
    if xq.is_cuda:
        m, k = xq.shape
        n = w_q.shape[0]
        if m <= 16 or k % 8 or n % 8:
            raise ValueError(
                f"int8 GEMM [{m}, {k}] x [{k}, {n}]: torch._int_mm on CUDA needs more than 16 "
                "rows and K and N multiples of 8"
            )
    return torch._int_mm(xq, w_q.t())


def int8_matmul_quantized_rhs(xq: torch.Tensor, xs: torch.Tensor, w_q: torch.Tensor,
                              w_scale: torch.Tensor) -> torch.Tensor:
    """The s8 x s8 contraction of pre-quantized activations [..., K] (the
    fused qkv quantizes once for three projections), dequantized to
    float32 [..., N]: y * x_scale * w_scale."""
    if torch.is_grad_enabled() and xs.requires_grad:
        raise RuntimeError("int8 linears are serving only: there is no backward through them")
    lead = xq.shape[:-1]
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), w_q).reshape(*lead, w_q.shape[0])
    return y.float() * xs * w_scale


def int8_linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """W8A8 dynamic linear: (x_q W_q^T) * s_row * s_col + bias, in x's dtype."""
    xq, xs = quantize_activations(x)
    y = int8_matmul_quantized_rhs(xq, xs, p["weight_q"], p["weight_scale"])
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def quantize_vit_params(params: dict, keys: tuple[str, ...] | None = None) -> dict:
    """The encoder tree with the layers' linears in ``keys`` (JAX's names;
    default ``VIT_INT8_DEFAULT_KEYS``) quantized; q, k and v go together,
    as the fused qkv. Patch embedding, position tables, LayerNorms and
    layer scales stay as they are. Returns a new tree."""
    keys = VIT_INT8_DEFAULT_KEYS if keys is None else tuple(keys)
    if ("q" in keys) != ("k" in keys) or ("q" in keys) != ("v" in keys):
        raise ValueError("q/k/v must be quantized together (fused QKV)")
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        new = dict(layer)
        if "q" in keys:
            if any("lora_a" in layer.get(n, {}) for n in ("q", "k", "v")):
                raise ValueError("unmerged LoRA adapters would be silently dropped by int8 "
                                 "quantization; fold them first (models/lora.py merge_lora)")
            new["qkv"] = quantize_linear(layer["qkv"])
        for k in ("attn_out", "mlp_in", "mlp_out"):
            if k in keys and k in layer:
                new[k] = quantize_linear(layer[k])
        layers.append(new)
    out["layers"] = layers
    return out


def quantize_detector_params(params: dict, keys: tuple[str, ...] | None = None) -> dict:
    """Quantize the encoder of a detector tree; FPN and heads stay as they
    are (a ResNet backbone has no encoder and passes through)."""
    bb = params["backbone"]
    if "vit" not in bb:
        return params
    return {**params, "backbone": {**bb, "vit": quantize_vit_params(bb["vit"], keys)}}
