"""DiT/BEiT ViT encoder, dense path (port of ``layoutdit_tpu/models/vit.py``).

Plain functions over a parameter dictionary, as in the JAX package:
patchify with (c, kh, kw) flattening and a linear over it, a CLS token,
absolute position embeddings (bicubically resampled for grids other
than the trained one), pre-LN blocks with eps 1e-12 and fp32 statistics,
a fused QKV projection whose K part has no bias, layer scale, and
``hidden_states`` taps (0 = embedding output, i = output of layer i).

Attention goes to the port's kernels: N <= 256 to the short kernel,
longer sequences to the flash kernel (on the CPU both wrappers run
their plain versions). That departs on purpose from the JAX package's
XLA-below-2048-tokens routing, which was measured on a TPU. The
projection and MLP matmuls stay ``torch`` matmuls, as the JAX package
leaves them to XLA.

Precision policy as in the JAX package: parameters fp32, matmul inputs
cast to ``compute_dtype``, LayerNorm/softmax/GELU statistics in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.ops.flash_attention import flash_attention
from layoutdit_tpu_torch.ops.interpolate import resize_bicubic
from layoutdit_tpu_torch.ops.short_attention import MAX_N as SHORT_MAX_N
from layoutdit_tpu_torch.ops.short_attention import short_attention_qkv, split_qkv


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    image_size: int = 224
    num_channels: int = 3
    layer_norm_eps: float = 1e-12
    layer_scale_init_value: float = 0.1
    initializer_range: float = 0.02

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


DIT_BASE = ViTConfig()


def _trunc_normal(shape, std, generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(
        t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
    )


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def init_vit_params(cfg: ViTConfig, generator: torch.Generator, device) -> dict:
    """Random init with the JAX package's distributions (trunc-normal
    0.02 weights, zero biases, zero CLS and position embeddings, layer
    scale ``layer_scale_init_value``). Linear weights are [out, in]."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    patch_in = cfg.num_channels * cfg.patch_size * cfg.patch_size
    std = cfg.initializer_range

    def lin(n_in, n_out, bias=True):
        p = {"weight": _trunc_normal((n_out, n_in), std, generator, device)}
        if bias:
            p["bias"] = _zeros((n_out,), device)
        return p

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "ln1": {"weight": torch.ones(d, device=device), "bias": _zeros((d,), device)},
            "ln2": {"weight": torch.ones(d, device=device), "bias": _zeros((d,), device)},
            # rows [q; k; v]; the k third of the bias stays zero (BEiT K
            # has no bias)
            "qkv": lin(d, 3 * d),
            "attn_out": lin(d, d),
            "mlp_in": lin(d, i),
            "mlp_out": lin(i, d),
            "lambda_1": torch.full((d,), cfg.layer_scale_init_value, device=device),
            "lambda_2": torch.full((d,), cfg.layer_scale_init_value, device=device),
        })
    return {
        "cls_token": _zeros((d,), device),
        "patch_embed": lin(patch_in, d),
        "pos_embed": _zeros((cfg.num_patches + 1, d), device),
        "layers": layers,
    }


def _layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics and fp32 affine, cast back."""
    return F.layer_norm(x.float(), x.shape[-1:], p["weight"], p["bias"], eps).to(x.dtype)


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    bias = p.get("bias")
    return F.linear(x, p["weight"].to(x.dtype), None if bias is None else bias.to(x.dtype))


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), C*p*p] with (c, kh, kw) flattening
    (torch Conv2d weight.reshape(out, -1) layout)."""
    b, c, h, w = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, p, p]
    return x.reshape(b, gh * gw, c * patch * patch)


def attention_core(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v from the fused projection [B, N, 3*H*D]
    -> [B, N, H, D]: the short kernels (differentiable) for N <= 256, the
    flash forward kernel beyond. The flash backward is not ported, so a
    gradient through N > 256 raises instead of taking a plain version."""
    scale = 1.0 / math.sqrt(qkv.shape[-1] // (3 * heads))
    if qkv.shape[1] <= SHORT_MAX_N:
        return short_attention_qkv(qkv, heads, scale=scale)
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError(
            f"attention over N={qkv.shape[1]} > {SHORT_MAX_N} tokens needs the flash "
            "backward kernel, which is not ported yet; train at a size whose "
            "token count fits the short kernel (224 px)"
        )
    return flash_attention(*split_qkv(qkv, heads), scale=scale)


def _attention(x: torch.Tensor, layer: dict, cfg: ViTConfig) -> torch.Tensor:
    b, n, d = x.shape
    qkv = _linear(x, layer["qkv"])  # [B, N, 3D]
    ctx = attention_core(qkv, cfg.num_attention_heads)
    return _linear(ctx.reshape(b, n, d), layer["attn_out"])


def _pos_embed_for_grid(pos_embed: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Absolute position embeddings for a (gh, gw) patch grid: patch
    entries bicubically resampled (HF BeitEmbeddings.interpolate_pos_encoding),
    the CLS entry unchanged."""
    n_pos = pos_embed.shape[0] - 1
    if n_pos == gh * gw:
        return pos_embed
    g0 = int(math.isqrt(n_pos))
    d = pos_embed.shape[1]
    patch = pos_embed[1:].reshape(g0, g0, d).permute(2, 0, 1)
    patch = resize_bicubic(patch, gh, gw)
    patch = patch.permute(1, 2, 0).reshape(gh * gw, d)
    return torch.cat([pos_embed[:1], patch], dim=0)


def encoder_block(x: torch.Tensor, layer: dict, cfg: ViTConfig) -> torch.Tensor:
    """One pre-LN block: attention + MLP with BEiT layer scale."""
    attn = _attention(_layer_norm(x, layer["ln1"], cfg.layer_norm_eps), layer, cfg)
    x = x + attn * layer["lambda_1"].to(attn.dtype)
    y = _layer_norm(x, layer["ln2"], cfg.layer_norm_eps)
    y = _linear(y, layer["mlp_in"])
    y = F.gelu(y.float()).to(y.dtype)
    y = _linear(y, layer["mlp_out"])
    return x + y * layer["lambda_2"].to(y.dtype)


def vit_forward(
    params: dict,
    pixels: torch.Tensor,
    cfg: ViTConfig,
    taps: Sequence[int] = (),
    compute_dtype: torch.dtype = torch.float32,
) -> list[torch.Tensor]:
    """Run the encoder on normalized pixels [B, C, H, W] (H, W multiples
    of the patch size); return hidden states [B, 1+P, D] at ``taps``
    (empty -> [final])."""
    taps = tuple(taps) or (cfg.num_hidden_layers,)
    _, _, img_h, img_w = pixels.shape
    gh, gw = img_h // cfg.patch_size, img_w // cfg.patch_size
    x = _linear(patchify(pixels, cfg.patch_size).to(compute_dtype), params["patch_embed"])
    b = x.shape[0]
    cls = params["cls_token"].to(compute_dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + _pos_embed_for_grid(params["pos_embed"], gh, gw).to(compute_dtype)

    collected: dict[int, torch.Tensor] = {}
    if 0 in taps:
        collected[0] = x
    for li, layer in enumerate(params["layers"], start=1):
        x = encoder_block(x, layer, cfg)
        if li in taps:
            collected[li] = x
    return [collected[t] for t in taps]
